"""Cache utilities: re-homing prefill caches into decode buffers (the
reference's ``repro.serving.kvcache``).

Prefill produces caches sized exactly to the prompt; decode needs head-room
for generated tokens.  ``grow_caches`` pads every *sequence-indexed* cache
(attention k/v, ``[.., B, S, KV, HD]``; latent attention's ``c_kv`` and
``k_pe``, ``[.., B, S, W]``) to the target length with zeros; recurrent
states (RWKV wkv/shift, RG-LRU h/conv) are fixed-size and pass through.  With a ``window`` (a model whose attention layers are all
local), a cache grows to ``min(window, target_len)``: the rolling buffer
that decode writes at ``pos % window``.

This differs from the reference, whose windowed buffer stays at its prompt
length ``s`` whenever ``s <= window``: decode then writes slot ``s`` past
the end of the buffer, which ``dynamic_update_slice`` clamps onto slot
``s − 1``, the last prompt token's K/V (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

_SEQ_KEYS = ("k", "v", "k_scale", "v_scale")
_LATENT_KEYS = ("c_kv", "k_pe")


def _grow_leaf(path, leaf: torch.Tensor, target_len: int,
               window: int) -> torch.Tensor:
    if any(key in path for key in _SEQ_KEYS):
        # attention cache [.., B, S, KV, HD] (leading stacked-layer dim
        # possible); window buffers grow up to the window's length
        seq_axis = leaf.dim() - 3
    elif any(key in path for key in _LATENT_KEYS):
        seq_axis = leaf.dim() - 2          # latent cache [.., B, S, W]
    else:
        return leaf
    s = leaf.shape[seq_axis]
    if window:
        target_len = min(window, target_len)
    if s >= target_len:
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
