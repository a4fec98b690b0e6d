"""The plain reference: each family's forward and loss in plain PyTorch
float32 (``dense.py``, ``ssm.py``), and the training steps, AdamW and the
readings the comparison takes (``train.py``).  Imports nothing of the port
and nothing of JAX; a family is found by the configuration's ``family``.
"""

import importlib


def family(name: str):
    """The reference module of a model family (``chipbench.reference.<name>``)."""
    return importlib.import_module(f"chipbench.reference.{name}")
