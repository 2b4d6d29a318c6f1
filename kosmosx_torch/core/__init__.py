"""Configs, initializers and parameter trees."""
