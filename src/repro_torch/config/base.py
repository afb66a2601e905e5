"""Configuration dataclasses for the tiny-task subsampling platform.

Every architecture in ``repro_torch.configs`` instantiates :class:`ModelConfig`;
the launcher composes it with a :class:`ShapeConfig` (one of the four
assigned input shapes) and a :class:`MeshConfig` (single- or multi-pod
production mesh) into a :class:`RunConfig`.

The *task-plane* fields (``scan_layers``, ``remat``, ``chunk_len``,
``microbatch_tokens_per_device``) are where the paper's tiny-task technique
surfaces in the model configs: chunk/microbatch sizes are chosen by the
kneepoint tuner (``repro_torch.core.kneepoint``) rather than hard-coded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used by ``layer_pattern`` (cycled over the depth of the model).
# ---------------------------------------------------------------------------
ATTN = "attn"        # full causal self-attention
LOCAL = "local"      # sliding-window causal attention
RGLRU = "rglru"      # RG-LRU recurrent block (recurrentgemma)
RWKV = "rwkv"        # RWKV6 time-mix (attention-free)
MLA = "mla"          # multi-head latent attention (DeepSeek-V2)

VALID_LAYER_KINDS = (ATTN, LOCAL, RGLRU, RWKV, MLA)
VALID_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "subsample")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (exact public-literature values)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # -- attention ---------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    local_window: int = 0                    # >0: window for LOCAL layers
    layer_pattern: Tuple[str, ...] = (ATTN,)
    logit_soft_cap: float = 0.0

    # -- multi-head latent attention (MLA layers), the source's key names ----
    # (q at full rank: the source's q_lora_rank null)
    kv_lora_rank: int = 0                    # the latent that the cache holds
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0                # one roped key shared by heads
    v_head_dim: int = 0
    # RoPE scaling as the source's ``rope_scaling`` group (a dict is taken
    # and kept as sorted (key, value) pairs); only "yarn" is known
    rope_scaling: Tuple[Tuple[str, Any], ...] = ()

    # -- mixture of experts --------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_dense_residual: bool = False         # arctic: dense FFN in parallel
    first_dense_layers: int = 0              # deepseek-moe: leading dense FFN
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    norm_topk_prob: bool = True              # renormalise the top-k gates
    # MoE token-plane tiny-tasking: the one-hot dispatch tensor [T,E,C] is
    # quadratic in tokens — long sequences are processed in segments of
    # this many positions (0 = unsegmented).  Segment length is a
    # kneepoint knob (traffic vs per-segment overhead).
    moe_seq_chunk: int = 0

    # -- rwkv6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64                # low-rank dims for data-dependent
    rwkv_lora_mix: int = 32                  # token-shift mixing

    # -- rg-lru hybrid -------------------------------------------------------
    lru_width: int = 0                       # 0 -> d_model
    conv_width: int = 4

    # -- modality frontends (STUBS per assignment) ---------------------------
    frontend: str = "none"                   # "none" | "patch" | "codec"
    num_patches: int = 0                     # patch embeddings prepended
    frontend_dim: int = 0                    # incoming embedding width

    # -- numerics ------------------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    kv_cache_dtype: str = "bfloat16"         # "bfloat16" | "int8"
    serve_shard_embed: bool = False          # FSDP-style serving (arctic)

    # -- beyond-paper §Perf optimizations (default off = baseline) -----------
    opt_onehot_ce: bool = False      # CE gold-logit via masked reduce, not
    #                                  take_along_axis on the sharded vocab
    #                                  dim (kills batch-wide logit gathers)
    opt_local_vocab: bool = False    # model-shard embedding d-dim + un-FSDP
    #                                  the head: no per-step table gathers
    moe_dispatch: str = "einsum"     # "einsum" (baseline) | "scatter" |
    #                                  "dropless" (experts sorted, no capacity)
    opt_moe_ff_shard: bool = False   # FSDP experts on the ff dim instead
    #                                  of d: kills per-layer expert-weight
    #                                  all-gathers (an activation-sized
    #                                  all-reduce replaces them)

    # -- task plane (paper technique) -----------------------------------------
    scan_layers: bool = True
    unroll_scans: bool = False               # roofline calibration: python
    #                                          loops instead of lax.scan so
    #                                          HLO cost analysis sees every
    #                                          iteration (DESIGN.md §7)
    remat: str = "full"                      # "none" | "full" | "dots"
    chunk_len: int = 128                     # recurrence/linear-attn chunk
    microbatch_tokens_per_device: int = 4096 # kneepoint-tuned target

    def __post_init__(self):
        assert self.family in VALID_FAMILIES, self.family
        for kind in self.layer_pattern:
            assert kind in VALID_LAYER_KINDS, kind
        if self.num_heads:
            assert self.num_heads % max(1, self.num_kv_heads) == 0
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))
        if MLA in self.layer_pattern:
            assert self.kv_lora_rank and self.qk_rope_head_dim % 2 == 0
        if self.rope_scaling:
            assert self.yarn.get("type") == "yarn", self.rope_scaling

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def yarn(self) -> Dict[str, Any]:
        """``rope_scaling`` as the source's dict (empty: plain RoPE)."""
        return dict(self.rope_scaling)

    @property
    def mla_qk_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.layer_kind(i) for i in range(self.num_layers))

    def is_sub_quadratic(self) -> bool:
        """True if decode state does not grow linearly with full history."""
        return all(k in (RGLRU, RWKV, LOCAL) for k in set(self.layer_kinds()))

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for li, kind in enumerate(self.layer_kinds()):
            n += 2 * d                                 # two norms
            if kind in (ATTN, LOCAL):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            elif kind == RGLRU:
                w = self.lru_dim
                n += 2 * d * w + w * d                 # in (x,gate), out proj
                n += self.conv_width * w + 2 * w       # conv + lru gates a,x
            elif kind == MLA:
                h, r = self.num_heads, self.kv_lora_rank
                n += d * h * self.mla_qk_dim           # wq
                n += d * (r + self.qk_rope_head_dim) + r   # w_kva, kv norm
                n += r * h * (self.qk_nope_head_dim + self.v_head_dim)
                n += h * self.v_head_dim * d           # wo
            elif kind == RWKV:
                h = self.d_model
                n += 4 * d * h + h * d                 # r,k,v,g + out
                n += d * self.rwkv_lora_decay + self.rwkv_lora_decay * h
                n += 7 * d + d                         # shift mixes, ln_x
                n += d                                 # bonus u
            # FFN
            if self.family == "moe":
                if li < self.first_dense_layers:
                    n += 3 * d * (self.first_dense_d_ff or self.d_ff)
                else:
                    n += self._moe_ffn_params()
            elif kind == RWKV:
                n += 2 * d * self.d_ff + d * d         # channel mix k,v + r
            else:
                n += 3 * d * self.d_ff                 # gated mlp
        return n

    def _moe_ffn_params(self) -> int:
        d = self.d_model
        n = self.num_experts * 3 * d * self.moe_d_ff
        n += self.num_shared_experts * 3 * d * self.moe_d_ff
        n += d * self.num_experts                      # router
        if self.moe_dense_residual:
            n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        routed_all = 0
        routed_active = 0
        for li, _ in enumerate(self.layer_kinds()):
            if li < self.first_dense_layers:
                continue
            routed_all += self.num_experts * 3 * d * self.moe_d_ff
            routed_active += self.moe_top_k * 3 * d * self.moe_d_ff
        return full - routed_all + routed_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


# The four assigned LM shapes (assignment block, verbatim numbers).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def dp_size(self) -> int:
        n = 1
        for a, s in zip(self.axis_names, self.shape):
            if a in ("pod", "data"):
                n *= s
        return n

    @property
    def tp_size(self) -> int:
        for a, s in zip(self.axis_names, self.shape):
            if a == "model":
                return s
        return 1


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"        # "float32" | "bfloat16" | "int8"
    grad_accum_dtype: str = "float32"    # "float32" | "bfloat16"
    grad_compression: str = "none"       # "none" | "int8"
    param_dtype: str = "float32"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    train: TrainConfig = TrainConfig()

    def microbatches(self) -> int:
        """Number of gradient-accumulation microbatches for a train step.

        Tiny-task policy: per-device microbatch working set is capped at
        ``microbatch_tokens_per_device`` (kneepoint-tuned); the global batch
        is split into that many tiny tasks, scheduled back-to-back by
        ``lax.scan`` (the device-side analogue of the paper's per-worker
        task queue).
        """
        if self.shape.kind != "train":
            return 1
        dp = self.mesh.dp_size
        per_dev_batch = max(1, self.shape.global_batch // dp)
        mb_batch = max(1, self.model.microbatch_tokens_per_device
                       // self.shape.seq_len)
        n_mb = max(1, per_dev_batch // mb_batch)
        # keep the global batch divisible: n_mb must divide per_dev_batch
        while per_dev_batch % n_mb:
            n_mb -= 1
        return n_mb
