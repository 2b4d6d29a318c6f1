"""Kosmos, KosmosLanguage, KosmosConditional and KosmosAny."""
