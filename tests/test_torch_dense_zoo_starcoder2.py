"""Reduced starcoder2-7b in the port vs the JAX reference: compiled leaves,
steps with each cache and served tokens (the cases are in
``tests/_dense_zoo.py``)."""
import pytest

pytest.importorskip("torch")

from _dense_zoo import *  # noqa: E402,F401,F403

ARCH = "starcoder2-7b"
