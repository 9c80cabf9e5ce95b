"""Tokenizer and the packed, blocked, impact-ordered segment format."""
