"""Cache utilities: re-homing prefill caches into decode buffers (the
reference's ``repro.serving.kvcache``).

Prefill produces caches sized exactly to the prompt; decode needs head-room
for generated tokens.  ``grow_caches`` pads every *sequence-indexed* cache
(attention k/v, ``[.., B, S, KV, HD]``) to the target length with zeros;
recurrent states (RWKV wkv/shift, RG-LRU h/conv) are fixed-size and pass
through, as do windowed (local-attention) rolling buffers.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

_SEQ_KEYS = ("k", "v", "k_scale", "v_scale")


def _grow_leaf(path, leaf: torch.Tensor, target_len: int,
               window: int) -> torch.Tensor:
    if not any(key in path for key in _SEQ_KEYS):
        return leaf
    # attention cache [.., B, S, KV, HD] (leading stacked-layer dim
    # possible); window buffers stay at window length
    seq_axis = leaf.dim() - 3
    s = leaf.shape[seq_axis]
    if (window and s <= window) or s >= target_len:
        return leaf
    pad = [0, 0] * (leaf.dim() - seq_axis - 1) + [0, target_len - s]
    return F.pad(leaf, pad)


def grow_caches(caches: Any, target_len: int, window: int = 0,
                path: tuple = ()) -> Any:
    if isinstance(caches, dict):
        return {key: grow_caches(val, target_len, window, path + (key,))
                for key, val in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(grow_caches(val, target_len, window, path + (i,))
                            for i, val in enumerate(caches))
    if caches is None:
        return None
    return _grow_leaf(path, caches, target_len, window)
