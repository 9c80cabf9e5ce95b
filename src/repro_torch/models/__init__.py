"""The model zoo's LM serving path: parameter declarations, RoPE,
attention on K5, and the dense decoder-only transformer."""
