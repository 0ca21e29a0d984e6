"""Host-side utilities (GIF encoding, HTML galleries)."""
