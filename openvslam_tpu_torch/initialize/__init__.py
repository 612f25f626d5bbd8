"""Map bootstrap."""
