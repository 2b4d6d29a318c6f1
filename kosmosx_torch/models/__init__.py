"""Kosmos and KosmosLanguage."""
