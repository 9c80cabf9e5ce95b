"""Synthetic corpora and queries."""
