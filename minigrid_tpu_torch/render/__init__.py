"""Frame rendering: the tile atlas and full-grid and point-of-view frames."""
