"""Host-side utilities (GIF encoding)."""
