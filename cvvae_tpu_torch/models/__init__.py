"""Model definitions (``nn.Module``s)."""
