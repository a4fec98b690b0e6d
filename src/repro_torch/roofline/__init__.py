"""Roofline analysis of a training or serving step: per-rank FLOPs, bytes
and collective bytes counted op by op (``op_cost.py``) and priced on the
H100 (``analysis.py``)."""
