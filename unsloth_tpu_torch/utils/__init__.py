"""Training metrics logging."""
