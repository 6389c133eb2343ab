"""Recursive dict <-> argparse.Namespace conversion.

Capability parity with the reference config loader (``utils.py:4-12`` in the
reference): YAML is loaded with ``yaml.safe_load`` and converted into nested
namespaces so config access is attribute-style (``config.model.ch``).
"""

from __future__ import annotations

import argparse


def dict2namespace(config: dict) -> argparse.Namespace:
    namespace = argparse.Namespace()
    for key, value in config.items():
        if isinstance(value, dict):
            value = dict2namespace(value)
        setattr(namespace, key, value)
    return namespace


def namespace2dict(namespace) -> dict:
    out = {}
    for key, value in vars(namespace).items():
        if isinstance(value, argparse.Namespace):
            value = namespace2dict(value)
        out[key] = value
    return out
