"""What decides ``correct``, one module per kind of cell."""
