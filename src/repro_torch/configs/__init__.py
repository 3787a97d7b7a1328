"""Service configurations."""
