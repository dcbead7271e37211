"""Typed configuration system — the PyTorch port's own copy.

Field for field the same dataclasses, presets, ``override``, ``to_dict`` and
``from_dict`` as ``dynamic_multiview_3d_tpu/config.py``, so a JAX
checkpoint's ``config.json`` loads here unchanged. The port keeps its own
copy because it imports nothing of the JAX package. Field comments still
describe the TPU design the fields were introduced for; fields the port does
not read (``use_pallas``, ``remat_scan`` under inference, the data/mesh
knobs of slices not yet ported) are kept for schema parity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the pose-conditioned encoder-decoder (SURVEY.md R6-R13)."""

    image_size: int = 128            # H == W
    base_features: int = 32          # encoder level-0 channels
    max_features: int = 256          # channel cap deeper in the stack
    num_levels: int = 5              # stride-2 downsamplings (128 -> 4)
    gru_features: int = 256          # recurrent state channels at the bottleneck
    rnn: str = "gru"                 # "gru" | "lstm" (ConvLSTM/GRU-style cell)
    pose_embed_dim: int = 64         # MLP embedding of the encoded pose
    pose_mode: str = "sincos"        # "sincos" (az/el/r) | "mat" (flat 4x4)
    norm: str = "group"              # "group" | "none"  (no batch stats -> DP-safe)
    up_kernel: int = 2               # decoder subpixel-upsample conv kernel
    up_order: str = "d2s_first"      # "d2s_first": up-conv -> pixel shuffle
                                     # -> norm/relu (round-2 layout) |
                                     # "norm_first": normalize the 4 phases
                                     # at LOW res (per-phase groups), relu,
                                     # THEN shuffle — the transpose lands
                                     # directly on the next conv's input
                                     # where XLA can fold it (kills the
                                     # standalone depth-to-space HBM op in
                                     # the round-2 trace)
    skip_fusion: str = "split"       # "split": conv_x(x) + conv_s(skip)
                                     # with the skip branch run once per
                                     # example [B] (round-2 layout) |
                                     # "concat": one conv over
                                     # [x, skip broadcast to B*K] — more
                                     # MXU FLOPs but no materialized add
                                     # feeding the norm (the 1.15 ms
                                     # HBM-bound op in the round-2 trace)
    max_flow: float = 0.5            # flow head range as a fraction of image size
    predict_depth: bool = False      # enable depth head + depth-reprojection path
    use_pallas: bool = True          # Pallas kernels on TPU, jnp fallback elsewhere
    warp_precision: str = "fast"     # "fast": 1-pass bf16 MXU (exact one-hots,
                                     # image sees bf16); "exact": f32 3-pass
    remat_scan: bool = False         # jax.checkpoint the recurrent scan body
    synthesis: str = "flow"          # "flow" (warp last frame + mask + rgb)
                                     # | "multiflow" (warp EVERY source frame
                                     #   with per-source flow + confidence
                                     #   softmax blend — true multiview)
                                     # | "depth" (reprojection of last frame)
                                     # | "multidepth" (ONE predicted target
                                     #   depth reprojects EVERY source frame;
                                     #   per-source confidence blend — the
                                     #   geometric twin of multiflow)
    multi_head_mode: str = "shared"  # multiflow/multidepth head layout:
                                     # "shared": ONE per-source head applied
                                     # over the source axis (shared weights;
                                     # pose conditioning pooled over sources
                                     # in the bottleneck, per-source FiLM at
                                     # the head) — the checkpoint is
                                     # T-AGNOSTIC: any source count at
                                     # inference (BASELINE.json:5's generic
                                     # predict(image_seq, ...) contract).
                                     # "baked": rounds 3-4 layout — one conv
                                     # emitting 3T+4 / T+4 channels with T
                                     # fixed at init. Checkpoints serialized
                                     # before this field existed load as
                                     # "baked" (config.from_dict).
    src_head_features: int = 32      # width of the shared per-source head
    dtype: str = "bfloat16"          # compute dtype (params stay float32)
    heads_dtype: str = ""            # head-conv compute dtype; "" follows
                                     # model.dtype. bfloat16 (the effective
                                     # default) skips the f32 materialization
                                     # of the full-res features (HBM-bound per
                                     # the round-2 roofline); accumulation is
                                     # f32 on the MXU either way and the
                                     # nonlinearities run in f32 on the 6-ch
                                     # output. Set float32 explicitly for
                                     # bit-level head precision on a bf16 model
                                     # (A/B-measured ΔPSNR < 1e-4 dB). NOTE:
                                     # checkpoints serialized before this
                                     # field existed load with bf16 heads
                                     # (their config JSON has no heads_dtype)
                                     # — re-evaluating such a model drifts by
                                     # the measured <1e-4 dB; pass --set
                                     # model.heads_dtype=float32 to reproduce
                                     # pre-change numbers bit-for-bit.

    @property
    def heads_compute_dtype(self) -> str:
        return self.heads_dtype or self.dtype

    @property
    def bottleneck_size(self) -> int:
        return self.image_size // (2 ** self.num_levels)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (SURVEY.md R1-R5 -> T1)."""

    source: str = "synthetic"        # "synthetic" | "frames" (frame-folder
                                     # video) | "shapenet_dir" (the published
                                     # 3D-R2N2 ShapeNet renderings layout,
                                     # ingested without conversion) |
                                     # "tfrecords" (tf.train.Example shards,
                                     # random-access framing index)
    root: str = ""                   # dataset root (or shard glob) for
                                     # frames/shapenet_dir/tfrecords
    image_size: int = 128
    seq_len: int = 1                 # T: input video frames
    src_views: str = "fixed"         # "fixed": one source camera films all T
                                     # frames | "orbit": each frame comes
                                     # from a DIFFERENT camera (true
                                     # multiview evidence — pairs with
                                     # model.synthesis="multiflow")
    num_targets: int = 1             # K: novel views per example
    batch_size: int = 16             # GLOBAL batch (split over the data mesh axis)
    num_scenes: int = 512            # synthetic: distinct procedural scenes
    scene_offset: int = 0            # synthetic: shift scene ids (disjoint
                                     # offsets = held-out-scene eval splits)
    dynamic: bool = False            # synthetic: objects move over the sequence
    seed: int = 0
    grain_workers: int = 4           # host-side decode worker count
    prefetch: int = 2
    use_native_packer: bool = True   # C++ decode/pack path when the .so is built
    device_preprocess: bool = True   # ship uint8, normalize on device (in-step)
    streaming: bool = False          # pull batches from the Grain iterator
                                     # (multi-worker prefetch; iterator state
                                     # checkpointed) instead of index batches
    targets_per_step: int = 0        # >0: subsample K targets on device with
                                     # jax.random.fold_in(step) (view-pair
                                     # sampling inside the jitted step)
    device_resident: str = "auto"    # "auto" | "on" | "off": keep the packed
                                     # uint8 frame banks in HBM and send only
                                     # int32 indices per step (data/resident.py
                                     # — kills per-step H2D traffic; auto = on
                                     # when packed + single-process + it fits
                                     # resident_budget_mb)
    resident_budget_mb: int = 4096   # HBM budget for device-resident banks
    materialize_packed: bool = False  # decode a non-packed source
                                     # (png / tfrecords / shapenet_dir)
                                     # ONCE into in-memory uint8 banks at
                                     # startup so it can ride the
                                     # HBM-resident path
    device_sampling: bool = False    # resident-only: draw (scene, views, t0)
                                     # INSIDE the compiled step from
                                     # fold_in(seed, step) — a dispatch then
                                     # consumes no host input at all. Stream
                                     # is seeded+resumable but differs from
                                     # the host sampler's (jax vs numpy rng)
    verify_crc: bool = False         # tfrecords: verify both masked CRCs of
                                     # every record during the index pass
                                     # (payload bit-flips otherwise parse
                                     # fine and feed garbage pixels
                                     # silently); off by default — it reads
                                     # every payload byte once at startup
    resident_sharding: str = "replicate"  # "replicate": every device holds
                                     # the full bank. "scenes": the bank is
                                     # SHARDED along the 'data' mesh axis by
                                     # scene (each shard trains on its own
                                     # scene subset — the HBM cost per chip
                                     # divides by the mesh size; requires
                                     # device_sampling and shard_map mode)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Losses + optimizer + checkpointing (SURVEY.md R13-R16 -> T4)."""

    optimizer: str = "adam"          # "adam" | "adamw" | "sgd"
    lr: float = 2e-4
    lr_schedule: str = "constant"    # "constant" | "cosine" (over num_steps)
    warmup_steps: int = 0            # linear warmup before the schedule
    lr_final: float = 0.0            # cosine floor (absolute lr)
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    l1_weight: float = 1.0
    mask_weight: float = 0.1         # BCE(mask, warp-validity) weight
    smooth_weight: float = 0.0       # optional flow smoothness
    ssim_weight: float = 0.0         # optional structural term:
                                     # ssim_weight * (1 - SSIM(view, tgt))
    geo_weight: float = 0.5          # masked L1 on the depth-reprojection
                                     # view (only when predict_depth)
    ema_decay: float = 0.0           # >0: keep an EMA of params in the
                                     # train state; the exported `model`
                                     # dir (eval/predict/serving) uses the
                                     # EMA weights
    steps_per_dispatch: int = 1      # >1: lax.scan this many optimizer steps
                                     # inside ONE compiled program per host
                                     # dispatch (t5x-style host loop).
                                     # Amortizes dispatch latency — the
                                     # dominant e2e cost through high-latency
                                     # links — and pairs naturally with
                                     # data.device_resident (per-dispatch host
                                     # work is stacking S index batches).
                                     # num_steps/ckpt_every/log_every should
                                     # be multiples of it (validated).
    num_steps: int = 100_000
    log_every: int = 100
    ckpt_every: int = 1000
    ckpt_dir: str = "/tmp/dmv3d_ckpt"
    max_to_keep: int = 3
    fail_after_step: int = -1        # fault injection for resume tests (-1 = off)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh (SURVEY.md §2b). data = DP axis; model = optional channel

    sharding on the widest convs/dense layers (kept 1 by default — the net is
    small; the axis exists so multi-chip plumbing is exercised end to end)."""

    data: int = -1                   # -1: all remaining devices
    model: int = 1
    multihost: bool = False          # call jax.distributed.initialize()


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    name: str = "default"


def _replace(cfg: Any, path: str, value: Any) -> Any:
    """Immutable deep-replace: _replace(cfg, 'model.image_size', 64)."""
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(cfg, **{head: _replace(getattr(cfg, head), rest, value)})
    old = getattr(cfg, head)
    if old is not None and not isinstance(value, type(old)):
        if isinstance(old, bool):
            value = str(value).lower() in ("1", "true", "yes")
        else:
            value = type(old)(value)
    return dataclasses.replace(cfg, **{head: value})


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def _known(cls, d: dict) -> dict:
    """Drop keys a newer/older config schema doesn't have (checkpoints carry
    their config as JSON — stay loadable across schema changes)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in fields}


def unknown_keys(d: dict) -> list[str]:
    """The keys of a config dict (``to_dict``'s form, a checkpoint's or an
    artifact's JSON) that this schema has no field for, as dotted paths;
    ``from_dict`` drops them."""
    sections = {"model": ModelConfig, "data": DataConfig,
                "train": TrainConfig, "mesh": MeshConfig}
    out = [k for k in d if k not in sections and k != "name"]
    for name, cls in sections.items():
        fields = {f.name for f in dataclasses.fields(cls)}
        out += [f"{name}.{k}" for k in d.get(name, {}) if k not in fields]
    return sorted(out)


def from_dict(d: dict) -> Config:
    model_d = dict(d["model"])
    # Pre-round-5 checkpoints trained the T-baked multi-source heads; their
    # config JSON has no multi_head_mode, so the field must NOT resolve to
    # the new default (the param trees differ).
    model_d.setdefault("multi_head_mode", "baked")
    return Config(
        model=ModelConfig(**_known(ModelConfig, model_d)),
        data=DataConfig(**_known(DataConfig, d["data"])),
        train=TrainConfig(**_known(TrainConfig, d["train"])),
        mesh=MeshConfig(**_known(MeshConfig, d["mesh"])),
        name=d.get("name", "default"),
    )


def override(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply CLI-style 'a.b.c=v' overrides."""
    for item in overrides:
        path, _, value = item.partition("=")
        cfg = _replace(cfg, path.strip(), value.strip())
    return cfg


# ---------------------------------------------------------------------------
# Presets: one per BASELINE.json eval config (lines 7-11).
# ---------------------------------------------------------------------------

def config1_single_view_64() -> Config:
    """BASELINE.json:7 — 1 image -> 1 novel view, 64x64, batch=1, CPU forward."""
    return Config(
        name="c1_single64",
        model=ModelConfig(image_size=64, num_levels=4, use_pallas=False,
                          dtype="float32"),
        data=DataConfig(image_size=64, seq_len=1, num_targets=1, batch_size=1),
    )


def config2_static_multiview_128() -> Config:
    """BASELINE.json:8 — static multiview, 128x128 + 8 target poses, batch=16."""
    return Config(
        name="c2_static128",
        model=ModelConfig(image_size=128, num_levels=5),
        data=DataConfig(image_size=128, seq_len=1, num_targets=8, batch_size=16),
    )


def config3_dynamic_scan() -> Config:
    """BASELINE.json:9 — dynamic: 8-frame sequence -> 4 views, scan, batch=8."""
    return Config(
        name="c3_dynamic",
        model=ModelConfig(image_size=128, num_levels=5, remat_scan=True),
        data=DataConfig(image_size=128, seq_len=8, num_targets=4, batch_size=8,
                        dynamic=True),
    )


def config3_multiflow_orbit() -> Config:
    """Flagship quality recipe (round 3): c3 dynamic shapes + true-multiview
    synthesis — every source frame warped with learned confidence blending
    (model.synthesis='multiflow') over orbiting source cameras
    (data.src_views='orbit'), in-program sampling. Runs out of the box on
    the in-memory synthetic frame bank (rendered once at startup); point
    data.root at a frames export (make_dataset --views 8 --seq-len 8
    --dynamic --fmt packed) for real data / bigger scene banks."""
    return Config(
        name="c3mf_multiflow_orbit",
        model=ModelConfig(image_size=128, num_levels=5, remat_scan=True,
                          synthesis="multiflow"),
        data=DataConfig(image_size=128, seq_len=8, num_targets=2,
                        batch_size=8, dynamic=True, source="frames",
                        src_views="orbit", device_sampling=True,
                        materialize_packed=True),
        train=TrainConfig(steps_per_dispatch=16, lr_schedule="cosine",
                          lr=2e-4, warmup_steps=500, lr_final=1e-5),
    )


def config3_multidepth_orbit() -> Config:
    """Best-quality recipe (round 4: 22.19 dB / 0.821 SSIM scene-holdout,
    BASELINE.md): the c3mf flagship shapes with multidepth synthesis — ONE
    predicted target-view depth map reprojects EVERY orbit source through
    its relative camera transform, per-source confidence blend in the same
    fused Pallas kernel. Multiflow-tier quality plus a usable depth map."""
    import dataclasses
    base = config3_multiflow_orbit()
    return dataclasses.replace(
        base, name="c3md_multidepth_orbit",
        model=dataclasses.replace(base.model, synthesis="multidepth"))


def config4_train_dp8() -> Config:
    """BASELINE.json:10 — full train step (L1+mask, fwd+bwd+Adam), 128², v5e-8 DP."""
    return Config(
        name="c4_train_dp8",
        model=ModelConfig(image_size=128, num_levels=5),
        data=DataConfig(image_size=128, seq_len=1, num_targets=2, batch_size=64),
        mesh=MeshConfig(data=8),
    )


def config5_multihost_256() -> Config:
    """BASELINE.json:11 — multi-host v5e-32, streamed video decode, 256² training."""
    return Config(
        name="c5_multihost256",
        model=ModelConfig(image_size=256, num_levels=6, remat_scan=True),
        data=DataConfig(image_size=256, seq_len=4, num_targets=2, batch_size=128,
                        dynamic=True, source="frames"),
        mesh=MeshConfig(data=32, multihost=True),
    )


PRESETS = {
    "c1": config1_single_view_64,
    "c2": config2_static_multiview_128,
    "c3": config3_dynamic_scan,
    "c3mf": config3_multiflow_orbit,
    "c3md": config3_multidepth_orbit,
    "c4": config4_train_dp8,
    "c5": config5_multihost_256,
    "default": Config,
}


def get_config(name: str = "default", overrides: Sequence[str] = ()) -> Config:
    return override(PRESETS[name](), overrides)
