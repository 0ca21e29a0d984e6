"""Host-side utilities (GIF encoding, HTML galleries, the tools' device)."""
