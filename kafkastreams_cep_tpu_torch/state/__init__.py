"""Host-side state of the streams layer: stores and their names."""
