"""Model problems."""
