"""Models of the port (dense family; see ``lm.py``)."""
