"""Blockwise int8 and top-k TDM payload compression."""
