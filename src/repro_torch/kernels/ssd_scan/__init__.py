"""The Mamba-2 chunked SSD scan."""
