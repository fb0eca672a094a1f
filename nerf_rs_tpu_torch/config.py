"""Configuration of the port: a copy of ``nerf_rs_tpu/config.py``, so the
port imports nothing of the JAX package. The dataclasses, their
validation, ``replace``, ``to_dict``, ``from_dict`` and ``hparams`` are
kept as they are there; ``tests/test_torch_config.py`` holds the two
copies to the same fields and defaults.

One dataclass unifies the reference's CLI flag surface (reference:
src/cli.rs:5-66 — 16 flags with defaults) with its compile-time model
constants (src/model.rs:7-13) and camera intrinsics
(src/ray_sampling.rs:7-16), per SURVEY.md §5.6. The config is
serializable into the run dir and into TensorBoard hparams.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics + canonical pose.

    Mirrors the reference's compile-time camera constants
    (src/ray_sampling.rs:7-16): a 128x128 screen, FOV pi/3, near plane
    ("hither") 0.05, far 2.0, camera at [0,0,-1] looking at [0,0,1]
    with +Y up.
    """

    width: int = 128
    height: int = 128
    fov: float = math.pi / 3.0
    near: float = 0.05
    far: float = 2.0
    origin: Tuple[float, float, float] = (0.0, 0.0, -1.0)
    at: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    # Blender-style datasets carry focal length instead of fov+hither.
    focal: Optional[float] = None
    # NDC ray reparameterization (NeRF paper appendix C, forward-facing
    # / LLFF captures): rays are warped once at generation
    # (ops/rays.ndc_rays) so the whole downstream stack samples the
    # unit NDC depth range — near/far MUST be (0, 1) when set.
    # ndc_near is the WORLD near-plane distance of the warp.
    ndc: bool = False
    ndc_near: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    """Radiance-field MLP architecture.

    Default is the paper-correct NeRF (arXiv 2003.08934 §5.1): gamma(x)
    with L=10, gamma(d) with L=4, 8x256 trunk with a skip connection
    injecting the encoded position at layer 5, a density head, and a
    view-dependent 128-wide RGB head. ``compat=True`` reproduces the
    reference's committed architecture instead (src/model.rs:45-93):
    raw xyz input, 8x100 trunk, no skip, 101-wide output whose channel 0
    is sigma, and a 100->50->4 sigmoid radiance head.
    """

    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4  # input re-injected before trunk layer index 4 (5th)
    pos_enc_levels: int = 10  # L for gamma(x)
    dir_enc_levels: int = 4  # L for gamma(d)
    include_input_in_enc: bool = True
    view_head_width: int = 128
    feature_width: int = 256
    use_viewdirs: bool = True
    sigma_activation: str = "relu"  # "relu" | "softplus" | "none" (compat)
    rgb_activation: str = "sigmoid"
    # Reference-compat architecture (src/model.rs:45-93).
    compat: bool = False
    compat_width: int = 100
    compat_head_width: int = 50
    # Architecture family: "nerf" (PE + 8x256 MLP, above), "hashgrid"
    # (Instant-NGP, arXiv 2201.05989: multiresolution hash encoding +
    # tiny MLPs — models/hashgrid.py), or "factored" (CP-decomposed
    # multiresolution lines, gather-free — the TPU-native fast field,
    # models/factored.py). compat=True overrides.
    arch: str = "nerf"
    # mip-NeRF integrated positional encoding (arXiv 2103.13415): each
    # sample is a conical-frustum Gaussian (mean, diag cov) and gamma
    # encodes its EXPECTED sinusoids, E[sin(2^l x)] =
    # sin(2^l mu) exp(-4^l var / 2) — high frequencies self-attenuate
    # with footprint, the anti-aliasing mechanism. Same trunk/head
    # weights as arch="nerf" (the encoding dim is unchanged). Rides
    # BOTH whole-ray kernels (in-register conical moments + damped
    # encoding — kernels/fused_ray.py, fused_train.py) since round 3.
    ipe: bool = False
    hash_levels: int = 16  # L resolution levels
    hash_features: int = 2  # F features per level entry
    hash_table_log2: int = 19  # log2(T) entries per level
    hash_base_res: int = 16  # N_min
    hash_max_res: int = 1024  # N_max
    hash_aabb: float = 1.6  # grid covers [-a, a]^3
    hash_mlp_width: int = 64  # tiny-MLP width (both nets; shared by
    # the factored family's heads)
    # Brick layout (TPU-native hash-table redesign, round 4): each
    # table entry is a 4^3-vertex BRICK covering 3^3 grid cells (one
    # 128-lane f32 row at F=2), so a (point, level) costs ONE aligned
    # 512 B row gather instead of 8 scattered 8 B corner pairs — the
    # row, not the element, is the TPU's random-access granule
    # (kernels/gather_rows.py docstring). Same parameter count (brick
    # entries are 64x bigger, 2^(hash_table_log2-6) of them per level).
    # Measured A/B: benchmarks/ab_hash_encode.py --brick.
    hash_brick: bool = False
    hash_geo_feats: int = 15  # sigma-net features feeding the color net
    # Factored (CP) family (models/factored.py):
    fac_levels: int = 6  # resolution-ladder levels
    fac_base_res: int = 16  # coarsest line resolution
    fac_max_res: int = 512  # finest line resolution
    fac_comps: int = 48  # CP rank (channels of the per-axis matmul)
    fac_aabb: float = 1.6  # field covers [-a, a]^3
    fac_init_scale: float = 0.25  # line init stddev
    # L1 penalty on the line tables (TensoRF §5's grid sparsity loss):
    # CP components are global axis products, so features inside the
    # object ring faint density streaks along axis-aligned corridors
    # outside it; L1 pulls unused knots to zero and suppresses the fog
    fac_l1: float = 0.0
    # Encode implementation. Default XLA: measured interleaved A/B
    # (benchmarks/ab_factored.py, v5e) put the XLA step at 6.7 ms vs
    # 13.2 for the Pallas kernel — XLA fuses the hat-weight build into
    # the dot as an operand fusion (W never hits HBM there either) and
    # pipelines it better; the kernel is a measured negative result
    # kept selectable (kernels/fused_factored.py; no point-cotangent).
    fac_fused: bool = False
    # mip-NeRF 360 scene contraction (arXiv 2111.12077 eq. 10;
    # ops/contract.py): sample positions (and IPE Gaussians, via the
    # closed-form linearization) are contracted into the radius-2 ball
    # before encoding — the unbounded-scene parameterization. Composes
    # with every family (set hash_aabb/fac_aabb to 2 for the grid
    # families). Pairs with RenderConfig.sampling_space="disparity".
    # Lives INSIDE both whole-ray kernels since round 4 (in-register
    # elementwise transform before the encoder — kernels/fused_render.
    # _contract_points/_contract_gaussian); XLA path for other families.
    contract: bool = False


@dataclass(frozen=True)
class RenderConfig:
    """Sampling + compositing options."""

    num_samples: int = 64  # coarse samples/ray (reference NUM_POINTS, model.rs:8)
    num_fine_samples: int = 0  # hierarchical fine samples (paper: 128)
    # ONE network for both hierarchical passes (mip-NeRF-style) instead
    # of the paper's separate coarse/fine MLPs. Enables the fast fine
    # pass: only the NEW fine samples are evaluated and the union is
    # composited from cached coarse evaluations (the paper's scheme
    # re-evaluates every coarse point through the fine MLP).
    share_network: bool = False
    # Fine-pass compositing set:
    #   "union"      — paper semantics: composite coarse ∪ fine samples.
    #   "standalone" — proposal-style (mip-NeRF 360 / NerfAcc lineage):
    #                  composite ONLY the fine samples; the coarse pass
    #                  acts purely as a sampling proposal. Skips the
    #                  per-ray union sort and the coarse re-evaluation —
    #                  the fast hierarchical path.
    fine_mode: str = "union"
    randomized: bool = True  # stratified jitter vs midpoints
    white_background: bool = False  # Blender scenes composite onto white
    # compat: reproduce the reference's effective t-sampling t = u*far
    # (precedence quirk at src/ray_sampling.rs:114) and its delta tail
    # delta_last = far - t_last (src/model.rs:184-187).
    compat_sampling: bool = False
    # compat: composite stacked densities as grayscale color with alpha=1
    # (src/model.rs:190-206) instead of the radiance head output.
    compat_density_color: bool = False
    raw_noise_std: float = 0.0  # sigma perturbation regularizer (paper appendix)
    # Occupancy-grid empty-space skipping (ops/occupancy.py, NerfAcc
    # lineage): a (res^3) EMA'd density grid concentrates the per-ray
    # sample budget in occupied bins (static shapes — the TPU form of
    # "skipping"). 0 disables; 64 is the standard resolution.
    occ_res: int = 0
    occ_bins: int = 64  # ray bins tested against the grid per sample draw
    occ_update_steps: int = 16  # grid EMA update cadence (train steps)
    occ_decay: float = 0.95  # per-update EMA decay (NerfAcc default)
    occ_threshold: float = 1e-2  # raw-sigma occupancy cutoff
    occ_aabb: float = 1.0  # scene AABB half-extent, [-a, a]^3
    # uniform-sampling floor blended into the occupancy PDF: keeps
    # empty bins supervised so floaters can't grow unchecked (measured
    # -7 dB on sparse scenes without it; ops/occupancy.occupancy_ts)
    occ_uniform_frac: float = 0.25
    # Stratification space for the uniform coarse/proposal sample draw:
    # "linear" (NeRF eq. 2) or "disparity" (even in 1/t — mip-NeRF 360's
    # unbounded spacing; pairs with ModelConfig.contract). Requires
    # near > 0. Hierarchical/proposal RESAMPLING is space-free (the
    # inverse CDF interpolates whatever bins it is given).
    # Pallas interpret-mode override for the fused RENDER kernel
    # (TrainConfig.kernel_interpret's twin): None = auto (interpret
    # unless the default backend is a TPU). Set True when rendering on
    # a CPU mesh while a TPU backend is also registered (the hermetic
    # multichip dryrun) — default_backend() can't see which devices a
    # shard_map program targets.
    kernel_interpret: Optional[bool] = None
    sampling_space: str = "linear"

    def __post_init__(self):
        if self.sampling_space not in ("linear", "disparity"):
            raise ValueError(
                f"sampling_space must be 'linear' or 'disparity' "
                f"(got {self.sampling_space!r})"
            )
        if self.occ_res > 0 and self.occ_update_steps < 1:
            raise ValueError(
                f"occ_update_steps must be >= 1 when occ_res > 0 "
                f"(got {self.occ_update_steps}); the grid EMA cadence "
                f"is a modulus in the train loop"
            )


@dataclass(frozen=True)
class ProposalConfig:
    """Proposal-network sampling (mip-NeRF 360 lineage; ops/proposal.py).

    When enabled, a tiny density-only MLP replaces the expensive main-
    network coarse pass: uniform ``num_samples`` -> proposal weights ->
    inverse-CDF resample -> the main MLP evaluates ONLY
    RenderConfig.num_samples guided points. The proposal trains against
    the main network's weight histogram (interlevel bound loss), not a
    photometric loss. Requires num_fine_samples == 0 (it IS the
    hierarchy) and a non-compat model.
    """

    enabled: bool = False
    num_samples: int = 64  # uniform samples the proposal evaluates
    # Resampling rounds through the ONE shared proposal MLP (multinerf
    # keeps a single PropMLP across its two proposal levels; separate
    # nets buy nothing at this scene scale but double the params).
    # Level 0 evaluates the uniform ts; each further level re-evaluates
    # the proposal at num_samples points drawn from the previous
    # histogram; the main MLP samples from the LAST histogram. The
    # interlevel bound loss is summed over every level.
    num_levels: int = 1
    net_depth: int = 4
    net_width: int = 64
    pos_enc_levels: int = 10
    loss_mult: float = 1.0  # interlevel loss weight
    # mip-NeRF 360 resampling annealing: over the first anneal_steps the
    # proposal weights used for DRAWING samples are exponentiated by
    # bias(step/anneal_steps, anneal_slope) in (0, 1] — early training
    # samples near-uniformly while the proposal histogram is still
    # garbage. 0 disables (round-2 behavior).
    anneal_steps: int = 0
    anneal_slope: float = 10.0


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + bookkeeping. Flag surface mirrors src/cli.rs:5-66."""

    num_rays: int = 4096  # rays per global batch (reference: 84, model.rs:7)
    learning_rate: float = 5e-4  # cli.rs:64-65
    lr_decay_steps: int = 0  # 0 = constant lr (reference behavior)
    lr_final: float = 5e-6
    num_iter: int = 50_000  # cli.rs:52-53
    eval_steps: int = 101  # cli.rs:55-56
    logging_steps: int = 101  # cli.rs:58-59
    save_steps: int = 1001  # cli.rs:61-62
    accumulation_steps: int = 1  # latent in reference (model.rs:327-336)
    # exponential moving average of the trainable weights, used for
    # eval/render when > 0 (Instant-NGP-style; the raw weights keep
    # training). 0 disables (reference behavior: no EMA anywhere).
    ema_decay: float = 0.0
    seed: int = 0
    precision: str = "mixed"  # "f32" | "bf16" | "mixed" (bf16 matmul, f32 master)
    # mip-NeRF 360 distortion loss weight (eq. 15, arXiv 2111.12077):
    # concentrates each ray's compositing weight into one compact
    # cluster (floater suppression). Applied to the FINEST pass's
    # weights (main pass under proposal sampling). 0 disables
    # (reference behavior: no regularizers, src/model.rs:296-299).
    distortion_weight: float = 0.0
    # highest-error ray resampling (reference README TODO, BASELINE
    # config 5): fraction of each batch drawn from the per-pixel error
    # distribution; 0 disables.
    error_resample_frac: float = 0.0
    error_resample_ema: float = 0.5
    # jax.profiler trace window: dump steps [profile_start,
    # profile_start+profile_steps) into the TB run dir (0 = off).
    profile_steps: int = 0
    profile_start: int = 10
    # rays per grid step of the fused whole-ray train kernel
    # (use_whole_ray_train); num_rays must divide by it. Swept on v5e at
    # S=64: R=32 9.23 / R=64 8.61 / R=128 8.27 ms, R=256 exceeds VMEM
    # (hierarchical/proposal passes rescale rows-per-block by S, so this
    # sets the R*S operating point, not a hard ray count).
    whole_ray_block: int = 128
    # Sub-blocks interleaved per grid step of the whole-ray train
    # kernel: 2 emits the halves' MXU ops adjacently so one half's
    # matmul overlaps the other's dependent VPU work (the ~100 vs 91
    # TFLOP/s probe, docs/PERFORMANCE.md). 1 = round-2 behavior.
    whole_ray_halves: int = 1
    # Pallas interpret-mode override for the fused kernels. None = auto
    # (interpret unless the default backend is a TPU). Set True when the
    # computation targets a CPU mesh while a TPU backend is also
    # registered (the hermetic multichip dryrun): default_backend()
    # can't see which devices a shard_map program runs on.
    kernel_interpret: Optional[bool] = None


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + multiview batch semantics (src/dataset.rs:63-139)."""

    # "multiview_png" | "blender" | "llff" | "sphere" | "flat_sphere"
    dataset: str = "multiview_png"
    img_dir: str = "data/monkey-128-no-shading-2d-6"  # cli.rs:19-20
    view_start: int = 0  # cli.rs:22-23
    view_end: int = 84  # cli.rs:25-26
    view_step: int = 1  # cli.rs:28-29
    num_views_per_hemisphere: int = 6  # cli.rs:31-32
    # batch construction:
    #   "per_ray"   — every ray draws (view, x, y) iid on-device (default)
    #   "multiview" — reference semantics (src/dataset.rs:63-139): sample
    #                 views_per_batch views with replacement, split rays
    #                 evenly (train() routes to sample_multiview_batch)
    #   "host"      — async host PrefetchPipeline (data/pipeline.py) with
    #                 ``prefetch`` buffered batches; gold gather via the
    #                 C++ assembler when use_native_loader and built.
    #                 For pixel stores too large for HBM.
    batch_mode: str = "per_ray"
    views_per_batch: int = 4  # distinct views per batch (multiview mode)
    # Shard the pixel store's VIEW axis over the data mesh instead of
    # replicating it: each device holds views/ndev views and samples
    # rays only from its local slice (iid per-ray draws over equal
    # slices == union sampling), so pod pixel stores scale past one
    # device's (and one host's) memory. per_ray batch mode only; view
    # counts are truncated to a multiple of the device count.
    shard_pixel_store: bool = False
    prefetch: int = 2  # async host pipeline depth (host mode)
    use_native_loader: bool = True  # C++ batch assembler when built (host mode)
    data_workers: int = 1  # parallel host assembly threads (host mode)
    # True when the user explicitly passed --near/--far on the command
    # line (set by cli.config_from_args from the parsed-flag record):
    # metric-mode LLFF then always honors the value, even if it equals
    # the parser default — the defaults-proxy alone can't tell an
    # explicit re-pass of the default from "unset" (ADVICE r4)
    near_explicit: bool = False
    far_explicit: bool = False
    # mip-NeRF multiscale training (arXiv 2103.13415 §4): >1 builds a
    # box-downsampled pixel pyramid with this many levels (1/1 .. 1/2^(L-1))
    # and every batch draws equal ray counts per level, each ray carrying
    # its level's cone radius (Batch.radii; consumed by --ipe, ignored by
    # point-sampled models — the paper's "NeRF on multiscale" baseline).
    # Equal per-level counts reproduce the paper's area-weighted loss in
    # expectation: union sampling weights levels by pixel count 4^-l and
    # then multiplies each loss by area 4^l — a constant per-level weight,
    # which equal partitioning gives directly with unit loss weights.
    multiscale_levels: int = 1
    # LLFF real-capture options (data/llff.py, dataset="llff"):
    llff_factor: int = 1  # load images_{factor}/ or decimate by it
    llff_holdout: int = 8  # every Nth view is test ("llffhold"); 0 = none


@dataclass(frozen=True)
class Config:
    """Top-level run configuration (CLI surface superset of cli.rs:5-66)."""

    debug: bool = False
    do_train: bool = True
    eval_on_train: bool = True
    live_preview: bool = False  # ANSI half-block eval frame in-terminal
    # (the headless form of the reference's live window, display.rs)
    log_densities_only: bool = False
    log_dir: str = "logs"  # cli.rs:34-35
    save_dir: str = "checkpoints"  # cli.rs:37-38
    load_path: str = ""  # cli.rs:49-50
    run_name: str = ""
    camera: CameraConfig = field(default_factory=CameraConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    proposal: ProposalConfig = field(default_factory=ProposalConfig)
    # Parallelism: number of data-parallel shards; 0 = all local devices.
    num_devices: int = 0
    # Render via the fused whole-ray Pallas kernel (kernels/fused_ray.py)
    # — ON by default since round 3: rebuilt on the free-reshape Mosaic
    # facts (no selector matmuls), it renders the 800x800 frame in
    # 0.57 s vs XLA's 0.834 (interleaved A/B, benchmarks/ab_render.py)
    # and compiles 37 s vs 121. Round 2's selector-based kernel lost
    # (~62 TFLOP/s) and XLA was the default then.
    use_fused_kernel: bool = True
    # route TRAINING through the whole-ray fused fwd+bwd kernel
    # (kernels/fused_train.py): one Pallas launch per step, activations
    # VMEM-resident, dW accumulated in VMEM. Coarse-only flagship
    # configs only (see train.step.whole_ray_supported).
    use_whole_ray_train: bool = False

    def __post_init__(self):
        if self.proposal.enabled and self.render.occ_res > 0:
            raise ValueError(
                "--use_proposal and --occ_res are mutually exclusive: "
                "the proposal MLP and the occupancy grid are competing "
                "sample-placement mechanisms with no defined composition "
                "(the proposal path ignores the grid)"
            )
        if self.camera.ndc:
            if (self.camera.near, self.camera.far) != (0.0, 1.0):
                raise ValueError(
                    "--ndc warps rays to the unit NDC depth range: set "
                    "--near 0 --far 1 (the WORLD near plane is "
                    "--ndc_near)"
                )
            if self.model.ipe:
                raise ValueError(
                    "--ndc with --ipe is not supported (the conical "
                    "radius math assumes metric world rays)"
                )
            if self.render.compat_sampling or self.model.compat:
                raise ValueError("--ndc is not part of the compat surface")
        if self.data.multiscale_levels > 1:
            if self.data.batch_mode != "per_ray":
                raise ValueError(
                    "--multiscale_levels needs per_ray batches (the "
                    "level partition lives in the on-device sampler)"
                )
            if self.train.error_resample_frac > 0:
                raise ValueError(
                    "--multiscale_levels is incompatible with error "
                    "resampling (the error store indexes full-res pixels)"
                )
            if self.data.shard_pixel_store:
                raise ValueError(
                    "--multiscale_levels with --shard_pixel_store is not "
                    "supported (shard the full-res store or the pyramid, "
                    "not both)"
                )
        if self.model.contract:
            if self.model.compat or self.render.compat_sampling:
                raise ValueError(
                    "--contract is not part of the compat surface"
                )
            if self.camera.ndc:
                raise ValueError(
                    "--contract and --ndc are competing scene "
                    "reparameterizations (radial contraction vs the "
                    "forward-facing projective warp) — pick one"
                )
            if self.render.occ_res > 0:
                raise ValueError(
                    "--contract with --occ_res is not supported: the "
                    "occupancy grid samples metric world ts inside its "
                    "AABB, which double-counts the contraction (grid the "
                    "contracted domain instead if this is ever needed)"
                )
        if self.render.sampling_space == "disparity":
            if self.camera.near <= 0.0:
                raise ValueError(
                    "--sampling_space disparity stratifies in 1/t: "
                    f"--near must be > 0 (got {self.camera.near})"
                )
            if self.render.compat_sampling:
                raise ValueError(
                    "--sampling_space disparity is not part of the "
                    "compat surface"
                )
        if self.model.ipe:
            if self.model.arch != "nerf" or self.model.compat:
                raise ValueError("--ipe requires the paper arch "
                                 "(arch=nerf, compat off)")
            # fine_mode: "standalone" composites the resampled intervals
            # alone (mip-NeRF's scheme); "union" runs the fine pass on
            # the MERGED coarse+resampled edge set. occ_res > 0 draws
            # the coarse edges from the occupancy PDF
            # (ops/occupancy.occupancy_edges) — interval-aware skipping.
            if self.proposal.enabled or self.render.compat_sampling:
                raise ValueError(
                    "--ipe supports stratified, occupancy-guided and "
                    "hierarchical interval sampling (no proposal/compat "
                    "samplers: they emit point samples, not intervals)"
                )
        if self.model.hash_brick and self.model.hash_features != 2:
            # fail at config construction, not at trace time deep in a
            # jitted step (ADVICE r4): the brick row packs 4^3 vertices
            # x F features into one 128-lane row, which is exact only
            # at F=2 (models/hashgrid.brick_encode)
            raise ValueError(
                "--hash_brick requires hash_features == 2 (one 4^3 "
                f"brick = 64 vertices x F = 128 lanes); got "
                f"hash_features={self.model.hash_features}"
            )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(Config)}
        # tolerate keys from retired config fields (e.g. round-2's
        # use_fused_train) so old run dirs' config.json still load
        kw = {k: v for k, v in d.items()
              if not isinstance(v, dict) and k in known}
        # tuples come back as lists from json
        cam = dict(d.get("camera", {}))
        for k in ("origin", "at", "up"):
            if k in cam and isinstance(cam[k], list):
                cam[k] = tuple(cam[k])
        return Config(
            camera=CameraConfig(**cam),
            model=ModelConfig(**d.get("model", {})),
            render=RenderConfig(**d.get("render", {})),
            train=TrainConfig(**d.get("train", {})),
            data=DataConfig(**d.get("data", {})),
            proposal=ProposalConfig(**d.get("proposal", {})),
            **kw,
        )

    def hparams(self) -> dict:
        """Numeric hparams for TB logging.

        Union of the reference's CLI-scalar map (cli.rs:68-79) and model
        consts map (model.rs:15-24) — unlike the reference, floats are
        not silently dropped.
        """
        out = {}
        flat = {
            **{f"train/{k}": v for k, v in dataclasses.asdict(self.train).items()},
            **{f"model/{k}": v for k, v in dataclasses.asdict(self.model).items()},
            **{f"render/{k}": v for k, v in dataclasses.asdict(self.render).items()},
            **{f"data/{k}": v for k, v in dataclasses.asdict(self.data).items()},
        }
        for k, v in flat.items():
            if isinstance(v, bool):
                out[k] = float(v)
            elif isinstance(v, (int, float)):
                out[k] = float(v)
        return out


def reference_compat_config() -> Config:
    """Config reproducing the reference's committed math exactly.

    8x100 no-skip raw-xyz MLP, sigma-as-grayscale compositing, t = u*far
    sampling, 84-ray/64-sample batches — per SURVEY.md §7 "compat
    reference" stance (quirks at src/ray_sampling.rs:114,
    src/model.rs:168-206).
    """
    return Config(
        model=ModelConfig(
            compat=True,
            sigma_activation="none",
            use_viewdirs=False,
            pos_enc_levels=0,
            dir_enc_levels=0,
            include_input_in_enc=True,
        ),
        render=RenderConfig(
            num_samples=64,
            compat_sampling=True,
            compat_density_color=True,
            white_background=False,
        ),
        train=TrainConfig(num_rays=84, precision="f32"),
        use_fused_kernel=False,
    )
