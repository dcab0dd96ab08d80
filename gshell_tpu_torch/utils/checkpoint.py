"""Checkpoints for preemption and resume (PyTorch twin of
``gshell_tpu/utils/checkpoint.py``): a rolling ``checkpoints-meta.pt``
snapshot restored on start-up, plus periodic ``checkpoint_{step}.pt``.
A save writes a temporary file and moves it over the old one, so a save cut
short leaves the previous snapshot whole."""
from __future__ import annotations

import os
from typing import Any

import torch


def save(path: str, state: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore(path: str, default: Any = None, map_location=None) -> Any:
    """The saved state (tensors in dicts and lists, and plain numbers), or
    ``default`` when no checkpoint exists."""
    if not os.path.exists(path):
        return default
    return torch.load(path, map_location=map_location, weights_only=True)


def save_periodic(workdir: str, state: Any, step: int, every: int, keep_meta: bool = True) -> None:
    """Rolling meta snapshot plus a numbered one every ``every`` steps."""
    if keep_meta:
        save(os.path.join(workdir, "checkpoints-meta.pt"), state)
    if every and step % every == 0:
        save(os.path.join(workdir, f"checkpoint_{step}.pt"), state)
