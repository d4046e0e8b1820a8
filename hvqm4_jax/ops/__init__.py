"""Device-side ops: the XLA compute path (reference layers L6/L7)."""
