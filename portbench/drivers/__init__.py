"""One module per kind of timed path, named by a cell's ``driver``."""
