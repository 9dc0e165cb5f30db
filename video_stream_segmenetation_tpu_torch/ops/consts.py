"""Constant tensors kept on their device.

A serving step reads constants made on the host (interpolation matrices,
tap indices, lane selections).  Copying one from pageable host memory to
the card blocks the host until the card has caught up, so a step that
made them anew each time could never run ahead of the card.
:func:`device_const` copies each constant once and keeps it; callers
must not write to what it returns.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_consts: dict = {}


def device_const(key, device, make) -> torch.Tensor:
    """The tensor ``make()`` (host data: a numpy array or a CPU tensor)
    on ``device``, made and copied on the first call for ``(key,
    device)`` and returned as it is after."""
    dev = torch.device(device)
    k = (key, dev)
    t = _consts.get(k)
    if t is None:
        v = make()
        t = (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
             else torch.as_tensor(v)).to(dev)
        with _lock:
            t = _consts.setdefault(k, t)
    return t
