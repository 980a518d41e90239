"""Static checks of the port's own sources (stdlib `ast` only)."""
