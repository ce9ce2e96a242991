"""The serving path's kernels, each beside its plain PyTorch version.

Four hand-written CUDA kernels (sources in ``ops/csrc``, built by
``ops/_build.py``) replace the Pallas kernels of ``climsim_tpu.ops.kernels``
that the coupling sidecar runs:

  * ``fused_input_transform``  -- cloud exponential rate, normalize,
    nan/inf -> 0, prune mask, clip: one pass over the raw columns
  * ``fused_mlp_forward``      -- the whole relu MLP in one launch, f32 or
    bf16 weights, float32 activations
  * ``fused_mlp_forward_int8`` -- the same with weight-only int8 weights,
    bf16-rounded activations
  * ``fused_constraint_head``  -- the U-Net v5 wrapper's postprocess:
    stratosphere zeroing, un-scaling, cloud repartition, the 368 contract

The U-Net's GroupNorm -> silu -> conv3 kernel is in ``ops/unet_fused.py``,
the counterpart module of ``climsim_tpu.ops.unet_fused``, and the fused
MLP-training kernel's forward and backward are in ``ops/fused_mlp_train.py``;
they count their launches here too.

Each public function checks its arguments, then takes the plain version
for a tensor on the CPU and launches its kernel for a tensor on a CUDA
device; there is no fallback from the kernel to the plain version.  Each
launch adds one to ``LAUNCHES[<name>]``, so a run can show that it went
through the kernels.  The ``*_plain`` functions hold the same math in
PyTorch: the CPU path, and the reference the kernels are checked against
on the card.

No lane padding: the kernels mask their own ragged edges.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import physics
from ..varspec import NUM_LEVELS
from . import _build

LAUNCHES = {"fused_input_transform": 0, "fused_mlp_forward": 0,
            "fused_mlp_forward_int8": 0, "fused_constraint_head": 0,
            "fused_gn_silu_conv3": 0, "fused_mlp_train_fwd": 0,
            "fused_mlp_train_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (None matches any size) on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: want a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raise for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for {x.device}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# --------------------------------------------------------------------------
# fused input transform
# --------------------------------------------------------------------------
TRANSFORM_ROWS = ("sub", "divinv", "mask", "lo", "hi", "lbd", "is_cloud")


def transform_consts(*, sub, divinv, mask, lo, hi, lbd, is_cloud,
                     device, dtype=torch.float32) -> torch.Tensor:
    """Stack the seven (D,) constant vectors in the kernel's row order into
    one (7, D) tensor on ``device``: float32 for the kernel, float64 for
    the plain version's oracle-parity path."""
    rows = [np.asarray(v, np.float64)
            for v in (sub, divinv, mask, lo, hi, lbd, is_cloud)]
    return torch.as_tensor(np.stack(rows), dtype=dtype, device=device)


def fused_input_transform_plain(x: torch.Tensor,
                                consts: torch.Tensor) -> torch.Tensor:
    sub, divinv, mask, lo, hi, lbd, is_cloud = consts
    x = torch.where(is_cloud > 0.5, 1.0 - torch.exp(-x * lbd), x)
    x = (x - sub) * divinv
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    x = x * mask
    return torch.clamp(x, lo, hi)


def fused_input_transform(x: torch.Tensor,
                          consts: torch.Tensor) -> torch.Tensor:
    """Raw (B, D) float32 -> normalized (B, D) float32; ``consts`` from
    ``transform_consts``."""
    _check(consts, "consts", torch.float32, (len(TRANSFORM_ROWS), None),
           consts.device)
    _check(x, "x", torch.float32, (None, consts.shape[1]), consts.device)
    if not _on_cuda(x, "fused_input_transform"):
        return fused_input_transform_plain(x, consts)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.cst_fused_input_transform(
            x.data_ptr(), consts.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], _stream(x.device))
    _build.check(code, "fused_input_transform")
    LAUNCHES["fused_input_transform"] += 1
    return out


# --------------------------------------------------------------------------
# fused constraint head (the U-Net v5 wrapper's postprocess)
# --------------------------------------------------------------------------
V5_OUT = 308        # t, q1, qn, u, v (60 each), 8 scalars
CONTRACT_OUT = 368  # t, q1, qc, qi, u, v (60 each), 8 scalars


def constraint_head_consts(out_scale, strato_lev_out: int,
                           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The (2, 308) rows of the head: the stratosphere mask (the top
    ``strato_lev_out`` levels of q1, qn, u and v zeroed) and 1 / out_scale
    (divided in float64, then rounded, as the reference wrapper does)."""
    mask = np.ones(V5_OUT)
    for start in (60, 120, 180, 240):   # q1, qn, u, v
        mask[start:start + strato_lev_out] = 0.0
    rows = np.stack([mask, 1.0 / np.asarray(out_scale, np.float64)])
    return torch.as_tensor(rows, dtype=dtype, device=device)


def fused_constraint_head_plain(y_norm, t, qc, qi, consts,
                                dt: float) -> torch.Tensor:
    """The XLA chain of climsim_tpu/online/wrapper.py:112-125."""
    mask, scaleinv = consts
    y = y_norm * mask * scaleinv
    dqc, dqi = physics.repartition_clouds(
        t, qc, qi, y[:, 0:NUM_LEVELS], y[:, 2 * NUM_LEVELS:3 * NUM_LEVELS],
        dt)
    return torch.cat([y[:, :2 * NUM_LEVELS], dqc, dqi, y[:, 3 * NUM_LEVELS:]],
                     dim=1)


def fused_constraint_head(y_norm: torch.Tensor, t: torch.Tensor,
                          qc: torch.Tensor, qi: torch.Tensor,
                          consts: torch.Tensor, dt: float) -> torch.Tensor:
    """Normalized v5 output (B, 308) and t, qc, qi before the step (B, 60),
    all float32 -> the raw (B, 368) coupling contract; ``consts`` from
    ``constraint_head_consts``, ``dt`` the coupling step in seconds."""
    _check(consts, "consts", torch.float32, (2, V5_OUT), consts.device)
    _check(y_norm, "y_norm", torch.float32, (None, V5_OUT), consts.device)
    for name, a in (("t", t), ("qc", qc), ("qi", qi)):
        _check(a, name, torch.float32, (y_norm.shape[0], NUM_LEVELS),
               consts.device)
    if not dt > 0:
        raise ValueError(f"dt {dt}: want a positive step")
    if not _on_cuda(y_norm, "fused_constraint_head"):
        return fused_constraint_head_plain(y_norm, t, qc, qi, consts, dt)
    out = torch.empty((y_norm.shape[0], CONTRACT_OUT), dtype=torch.float32,
                      device=y_norm.device)
    if y_norm.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(y_norm.device):
        code = lib.cst_fused_constraint_head(
            y_norm.data_ptr(), t.data_ptr(), qc.data_ptr(), qi.data_ptr(),
            consts.data_ptr(), out.data_ptr(), y_norm.shape[0], dt,
            _stream(y_norm.device))
    _build.check(code, "fused_constraint_head")
    LAUNCHES["fused_constraint_head"] += 1
    return out


# --------------------------------------------------------------------------
# fused MLP forward
# --------------------------------------------------------------------------
def _host_f32(a) -> torch.Tensor:
    """A numpy array or tensor as a contiguous float32 CPU tensor."""
    return torch.as_tensor(a).detach().to(
        device="cpu", dtype=torch.float32).contiguous()


MAX_LAYERS = 16  # kMaxLayers in csrc/common.cuh
CHUNK = 64       # the wgmma kernel's K chunk and output column slice


def _padded(width: int) -> int:
    return -(-width // CHUNK) * CHUNK


@dataclass(frozen=True)
class PackedMLP:
    """A relu MLP's parameters in the layout of the fused-MLP kernels.

    ``widths`` is (d_in, h_1, ..., d_out).  float32 weights (the FMA
    kernel): ``w`` holds every layer's (d_in, d_out) row-major weights, one
    layer after the other, and ``b`` every layer's bias.  bf16 and int8
    weights (the tensor-core kernel, ``csrc/mlp_forward_wgmma.cuh``): ``w``
    stacks every layer's weights, each zero-padded to (Kp, Np) = (d_in,
    d_out) rounded up to CHUNK, in one (sum Kp, max Np) matrix, and ``b``
    and ``scale`` (int8: per output channel, float32) hold every layer's
    Np values, zero past d_out; so no weight box the kernel reads has a
    ragged edge.  ``layers()`` yields the unpadded views of either.
    """

    widths: tuple[int, ...]
    w: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor | None = None

    @property
    def padded(self) -> bool:
        """Whether the buffers are the tensor-core kernel's padded layout."""
        return self.w.dtype != torch.float32

    def __post_init__(self):
        if self.padded:
            kp = [_padded(d) for d in self.widths]
            w_ok = tuple(self.w.shape) == (sum(kp[:-1]), max(kp[1:]))
            n_b = sum(kp[1:])
        else:
            w_ok = self.w.numel() == sum(
                i * o for i, o in zip(self.widths[:-1], self.widths[1:]))
            n_b = sum(self.widths[1:])
        if (not w_ok or self.b.numel() != n_b
                or (self.scale is not None and self.scale.numel() != n_b)):
            raise ValueError(f"buffers do not match widths {self.widths}")

    def layers(self):
        """Yield (w (d_in, d_out), b, scale or None) views per layer."""
        ro = bo = 0
        for din, dout in zip(self.widths[:-1], self.widths[1:]):
            s = None if self.scale is None else self.scale[bo:bo + dout]
            if self.padded:
                yield self.w[ro:ro + din, :dout], self.b[bo:bo + dout], s
                ro, bo = ro + _padded(din), bo + _padded(dout)
            else:
                yield (self.w[ro:ro + din * dout].view(din, dout),
                       self.b[bo:bo + dout], s)
                ro, bo = ro + din * dout, bo + dout


def pack_layers(layers, device=None) -> PackedMLP:
    """A PackedMLP of (w (d_in, d_out), b, scale or None) triples that chain,
    such as another pack's ``layers()``, taken as they are: float32, bf16
    or int8 weights, no rounding and no quantization.  ``device``: that of
    the first weight if None."""
    layers = list(layers)
    w0 = layers[0][0]
    device = w0.device if device is None else device
    widths = (w0.shape[0],) + tuple(w.shape[1] for w, _, _ in layers)
    if w0.dtype == torch.float32:
        return PackedMLP(widths, torch.cat([w.reshape(-1) for w, _, _ in
                                            layers]).to(device),
                         torch.cat([b for _, b, _ in layers]).to(device))
    kp = [_padded(d) for d in widths]
    w = w0.new_zeros(sum(kp[:-1]), max(kp[1:]), device=device)
    b = torch.zeros(sum(kp[1:]), dtype=torch.float32, device=device)
    scale = None if layers[0][2] is None else torch.zeros_like(b)
    ro = bo = 0
    for i, (wi, bi, si) in enumerate(layers):
        w[ro:ro + widths[i], :widths[i + 1]] = wi
        b[bo:bo + widths[i + 1]] = bi
        if scale is not None:
            scale[bo:bo + widths[i + 1]] = si
        ro, bo = ro + kp[i], bo + kp[i + 1]
    return PackedMLP(widths, w, b, scale)


def pack_mlp(weights, biases, weights_dtype=torch.bfloat16,
             device="cuda") -> PackedMLP:
    """Pack (d_in, d_out) weights and biases once, at build time.

    ``weights_dtype`` is torch.float32, torch.bfloat16 or ``"int8"``
    (per-output-channel symmetric, ``quantize_weights_int8``).  Weights are
    taken to float32 first, so bf16 rounds from float32 as the reference's
    ``w.astype(jnp.bfloat16)`` does.
    """
    ws = [_host_f32(w) for w in weights]
    bs = [_host_f32(b) for b in biases]
    if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"want 1..{MAX_LAYERS} layers with one bias each, "
                         f"got {len(ws)} weights and {len(bs)} biases")
    widths = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.shape != (widths[i], widths[i + 1]) or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} and bias "
                             f"{tuple(b.shape)} do not chain from "
                             f"width {widths[i]}")
    scales = [None] * len(ws)
    if weights_dtype == "int8":
        ws, scales = quantize_weights_int8(ws)
    elif weights_dtype in (torch.float32, torch.bfloat16):
        ws = [w.to(weights_dtype) for w in ws]
    else:
        raise ValueError(f"weights_dtype {weights_dtype!r}: want "
                         "torch.float32, torch.bfloat16 or 'int8'")
    return pack_layers(zip(ws, bs, scales), device)


def _relu_tail(h: torch.Tensor, relu_tail: int) -> torch.Tensor:
    if relu_tail <= 0:
        return h
    d = h.shape[1]
    return torch.cat([h[:, :d - relu_tail], torch.relu(h[:, d - relu_tail:])],
                     dim=1)


def _plain_chain(x, mlp, relu_tail, layer):
    """``layer(h, w, b, s)`` through the network, relu between layers and
    on the last ``relu_tail`` outputs."""
    h = x
    layers = list(mlp.layers())
    for i, (w, b, s) in enumerate(layers):
        y = layer(h, w, b, s)
        h = torch.relu(y) if i < len(layers) - 1 else y
    return _relu_tail(h, relu_tail)


def fused_mlp_forward_plain(x: torch.Tensor, mlp: PackedMLP,
                            relu_tail: int = 0) -> torch.Tensor:
    return _plain_chain(x, mlp, relu_tail,
                        lambda h, w, b, s: h @ w.float() + b)


def fused_mlp_forward_int8_plain(x: torch.Tensor, mlp: PackedMLP,
                                 relu_tail: int = 0) -> torch.Tensor:
    # bf16 x bf16 products are exact in float32: the float32 product of the
    # rounded operands is the bf16 dot with float32 accumulation
    return _plain_chain(
        x, mlp, relu_tail,
        lambda h, q, b, s: (h.to(torch.bfloat16).float() @ q.float()) * s + b)


def split_bf16x3(h: torch.Tensor):
    """(hi, mid, lo) bf16 with hi + mid + lo == h exactly, as the tensor-core
    kernel 2 splits its float32 activations: hi is h truncated to bf16 (its
    top 16 bits), mid the remainder truncated, lo what is left; the two
    subtractions are exact in float32, and lo takes the last 8 significant
    bits whole.  Exact for every finite h of magnitude >= 2**-110; below
    that lo may lose a residue under bf16's subnormal spacing (2**-133).
    A non-finite h goes whole into hi (NaN stays NaN, inf inf) with mid = lo
    = 0, so the products are float32's inf * w and NaN."""
    h = h.float()
    mask = torch.tensor(-65536, dtype=torch.int32)          # 0xffff0000

    def trunc(v):
        return (v.view(torch.int32) & mask).view(torch.float32)

    finite = torch.isfinite(h)
    hf = torch.where(finite, h, torch.zeros_like(h))
    hi = trunc(hf)
    r1 = hf - hi
    mid = trunc(r1)
    lo = r1 - mid
    hi = torch.where(finite, hi, h)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


TILE_ROWS = (4, 16)  # the tile heights the float32-weight kernel is built for


def _tile_rows(rows: int, device: torch.device) -> int:
    """Rows a block of the float32-weight (FMA) kernel: 16 once every SM
    gets a block of 16 (fewer re-reads of the weights from L2), else 4, so
    B = 384 (one ne4 chunk) runs as 96 blocks."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 16 if rows >= 16 * n_sm else 4


def _launch_mlp(entry: str, x: torch.Tensor, mlp: PackedMLP,
                relu_tail: int, tile_rows: int | None = None) -> torch.Tensor:
    """Launch the float32-weight FMA entry; ``tile_rows`` (one of
    TILE_ROWS) fixes the tile height, which ``_tile_rows`` picks
    otherwise."""
    out = torch.empty((x.shape[0], mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    tb = tile_rows or _tile_rows(x.shape[0], x.device)
    if tb not in TILE_ROWS:
        raise ValueError(f"{entry}: tile_rows {tb}, want one of {TILE_ROWS}")
    ld = -(-max(mlp.widths[:-1]) // 4) * 4
    smem = 2 * tb * ld * 4
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{entry}: a layer input of width "
                         f"{max(mlp.widths[:-1])} needs {smem} B of shared "
                         f"memory at {tb} rows a block; the card has {limit}")
    if mlp.w.data_ptr() % 16:
        raise ValueError(f"{entry}: packed weights must be 16-byte aligned "
                         "(the kernel loads 4 columns at a time)")
    widths = (ctypes.c_int * len(mlp.widths))(*mlp.widths)
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = getattr(lib, "cst_" + entry)(
            x.data_ptr(), mlp.w.data_ptr(), mlp.b.data_ptr(), out.data_ptr(),
            widths, len(mlp.widths) - 1, x.shape[0], relu_tail, tb,
            _stream(x.device))
    _build.check(code, entry)
    return out


# --------------------------------------------------------------------------
# the tensor-core kernel of kernels 2 (bf16 weights) and 3 (int8 weights)
# --------------------------------------------------------------------------
# The plan mirrors csrc/mlp_forward_wgmma.cuh: a cluster of `cluster` CTAs
# owns a row tile of 64 * nwg rows; CTA `rank` owns every layer's output
# chunks j (CHUNK columns each) with j % cluster == rank, at most nb of
# them, and publishes them in its shared memory for the next layer, whose
# K chunks the CTAs read from their owners; weights stream through
# `stages` TMA stages of CHUNK K rows by nb chunks.
MLP_STAGES = 6          # the most weight stages a plan takes
MLP_MAX_NB = 2
MLP_CLUSTERS = (16, 8)  # cluster sizes, largest first


@dataclass(frozen=True)
class MlpPlan:
    """How the tensor-core kernel tiles one (B, widths) call."""
    nwg: int            # 64-row warpgroups a CTA: rows a tile = 64 * nwg
    cluster: int        # CTAs a cluster
    nb: int             # output chunks a CTA owns of the widest layer
    stages: int         # weight stages in flight
    tiles_m: int        # row tiles (clusters)
    smem: int           # dynamic shared memory a CTA, bytes

    @property
    def rows(self) -> int:
        return 64 * self.nwg

    @property
    def grid(self) -> int:
        return self.tiles_m * self.cluster


def _mlp_chunk_bytes(int8: bool, nwg: int) -> int:
    """Bytes of one activation chunk of 64 nwg rows by CHUNK columns: one
    bf16 plane (int8 weights) or three, hi, mid and lo (bf16 weights)."""
    return (1 if int8 else 3) * 64 * nwg * CHUNK * 2


def _mlp_smem(int8: bool, nwg: int, nb: int, stages: int) -> int:
    """``smem_layout(...).total`` of the kernel: the weight ring (int8: the
    raw boxes, then four widened bf16 stages); the activation ring, a chunk
    a stage; the layer table; four barriers a stage (int8: and two a
    widened stage); the base's 1024-byte alignment.  ``chip_smoke.py``
    holds it against the library's own (``cst_mlp_forward_smem``)."""
    box = CHUNK * CHUNK * (1 if int8 else 2)
    conv = 4 * nb * CHUNK * CHUNK * 2 if int8 else 0
    return (stages * nb * box + conv + stages * _mlp_chunk_bytes(int8, nwg)
            + 32 * (MAX_LAYERS + 1) + 32 * stages + (64 if int8 else 0)
            + 1024)


@functools.lru_cache(maxsize=4096)
def plan_mlp_forward(rows: int, widths: tuple, smem_limit: int, n_sm: int,
                     max_cluster: int, int8: bool = False) -> MlpPlan:
    """The tensor-core kernel's plan for x (rows, widths[0]) through the
    MLP of ``widths`` on a card with ``smem_limit`` bytes of shared memory
    a block and ``n_sm`` SMs, where clusters of up to ``max_cluster`` CTAs
    schedule; raises ValueError, with the reason, for a call it cannot
    take.

    The rules the sweep of ``bench_mlp_forward --sweep`` found on an H100:
    while the 64-row tiles fit in the clusters of 16 the SMs hold at once
    (n_sm // 16), clusters of 16 CTAs a 64-row tile, one 64-column chunk a
    CTA of a 1024-wide layer; past that, fewer CTAs a tile, each reading
    every weight for more rows: clusters of 8 over 128-row tiles, or of
    16 where 8 CTAs cannot cover the widest layer (widths past 1024).  Then
    the fewest chunks a CTA that cover the widest layer, and the most
    weight stages, up to MLP_STAGES, that fit.  Rows, tiles and cluster
    change with B and the card; the order in which every output sums its
    K chunks (ascending) does not."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= len(widths) - 1 <= MAX_LAYERS or min(widths) < 1:
        raise ValueError(f"widths {widths}: want 1..{MAX_LAYERS} layers of "
                         "positive widths")
    if rows < 1:
        raise ValueError(f"rows {rows}: want at least 1")
    if max_cluster < MLP_CLUSTERS[-1]:
        raise ValueError(f"the card schedules no cluster of "
                         f"{MLP_CLUSTERS[-1]} CTAs for this kernel "
                         f"(largest {max_cluster})")

    def chunks_a_cta(cluster):
        return max(-(-w // (CHUNK * cluster)) for w in widths)

    one_wave = -(-rows // 64) <= n_sm // 16
    cluster = 16 if max_cluster >= 16 and (
        one_wave or chunks_a_cta(8) > MLP_MAX_NB) else 8
    nwg = 1 if (cluster == 16 and one_wave) or rows <= 64 else 2
    nb = chunks_a_cta(cluster)
    if nb > MLP_MAX_NB:
        raise ValueError(f"a layer of width {max(widths)} needs {nb} chunks "
                         f"of {CHUNK} columns a CTA in a cluster of "
                         f"{cluster}; the kernel takes {MLP_MAX_NB} (widths "
                         f"up to {MLP_MAX_NB * CHUNK * cluster})")
    stages = None
    for n in (nwg, 1):
        fits = [s for s in range(2, MLP_STAGES + 1)
                if _mlp_smem(int8, n, nb, s) <= smem_limit]
        if fits:
            nwg, stages = n, fits[-1]
            break
    if stages is None:
        raise ValueError(f"widths {widths} need "
                         f"{_mlp_smem(int8, 1, nb, 2)} B of shared memory; "
                         f"the card has {smem_limit}")
    return MlpPlan(nwg, cluster, nb, stages, -(-rows // (64 * nwg)),
                   _mlp_smem(int8, nwg, nb, stages))


_ACTIVE_CLUSTERS: dict = {}


def _active_clusters(dev: torch.device, int8: bool, plan: MlpPlan) -> int:
    """Clusters of ``plan``'s shape the card holds at once
    (cudaOccupancyMaxActiveClusters), asked once a device and shape."""
    key = (dev.index, int8, plan.nwg, plan.nb, plan.cluster, plan.smem)
    if key not in _ACTIVE_CLUSTERS:
        lib = _build.load()
        fn = (lib.cst_mlp_forward_clusters_int8 if int8
              else lib.cst_mlp_forward_clusters_bf16)
        with torch.cuda.device(dev):
            n = fn(plan.nwg, plan.nb, plan.cluster, plan.smem)
        if n < 0:
            _build.check(-n, "mlp_forward_clusters")
        _ACTIVE_CLUSTERS[key] = n
    return _ACTIVE_CLUSTERS[key]


def _mlp_plan(rows: int, mlp: PackedMLP, dev: torch.device) -> MlpPlan:
    """The plan on ``dev``: the largest cluster the card schedules for it,
    asked of the card, never found by a failed launch."""
    props = torch.cuda.get_device_properties(dev)
    int8 = mlp.w.dtype == torch.int8
    for max_cluster in MLP_CLUSTERS:
        plan = plan_mlp_forward(rows, mlp.widths,
                                props.shared_memory_per_block_optin,
                                props.multi_processor_count, max_cluster,
                                int8)
        if _active_clusters(dev, int8, plan) > 0:
            return plan
    raise ValueError(f"the card schedules no cluster for widths "
                     f"{mlp.widths} at B={rows}")


def check_mlp_forward(mlp: PackedMLP, device, batches) -> None:
    """Raise, with the reason, where the tensor-core kernel has no plan on
    ``device`` for ``mlp`` at one of ``batches``, so that a server finds
    out when it packs the weights, not at a request.  A plan takes one
    shape for the batches that fill no more than one wave of clusters and
    another past that, so the smallest and the largest batch a caller runs
    check every batch between.  Nothing to check on the CPU or for float32
    weights."""
    device = torch.device(device)
    if device.type != "cuda" or not mlp.padded:
        return
    for b in batches:
        _mlp_plan(b, mlp, device)


def _launch_wgmma(x: torch.Tensor, mlp: PackedMLP, relu_tail: int,
                  passes: int = 3, plan: MlpPlan | None = None
                  ) -> torch.Tensor:
    """The tensor-core kernel on checked CUDA tensors; ``passes`` (bf16
    weights only) is how many of the activations' three bf16 parts enter
    the products: 3 forms kernel 2's float32 products, 1 and 2 exist for the
    card's planted-fault check.  ``plan`` replaces ``_mlp_plan``'s (the
    benchmark's sweep)."""
    out = torch.empty((x.shape[0], mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    plan = plan or _mlp_plan(x.shape[0], mlp, x.device)
    int8 = mlp.w.dtype == torch.int8
    # the layers' activations between the CTAs of a cluster, through L2:
    # two buffers of every row tile's chunks
    n_chunks = max(-(-w // CHUNK) for w in mlp.widths[:-1])
    act = torch.empty(2 * plan.tiles_m * n_chunks
                      * _mlp_chunk_bytes(int8, plan.nwg) // 2,
                      dtype=torch.bfloat16, device=x.device)
    widths = (ctypes.c_int * len(mlp.widths))(*mlp.widths)
    lib = _build.load()
    tail = (x.shape[0], relu_tail, plan.nwg, plan.nb, plan.cluster,
            plan.stages)
    with torch.cuda.device(x.device):
        if int8:
            code = lib.cst_fused_mlp_forward_int8(
                x.data_ptr(), mlp.w.data_ptr(), mlp.scale.data_ptr(),
                mlp.b.data_ptr(), out.data_ptr(), act.data_ptr(), widths,
                len(mlp.widths) - 1, *tail, _stream(x.device))
            entry = "fused_mlp_forward_int8"
        else:
            code = lib.cst_fused_mlp_forward_bf16(
                x.data_ptr(), mlp.w.data_ptr(), mlp.b.data_ptr(),
                out.data_ptr(), act.data_ptr(), widths, len(mlp.widths) - 1,
                *tail, passes, _stream(x.device))
            entry = "fused_mlp_forward_bf16"
    _build.check(code, entry)
    return out


def _check_mlp(x: torch.Tensor, mlp: PackedMLP, weight_dtypes,
               relu_tail: int) -> None:
    if mlp.w.dtype not in weight_dtypes:
        raise TypeError(f"weights are {mlp.w.dtype}, want one of "
                        f"{weight_dtypes}")
    if not 0 <= relu_tail <= mlp.widths[-1]:
        raise ValueError(f"relu_tail {relu_tail} outside 0..{mlp.widths[-1]}")
    for name, t in (("w", mlp.w), ("b", mlp.b), ("scale", mlp.scale)):
        if t is not None:
            _check(t, name, t.dtype, tuple(None for _ in t.shape), x.device)
    _check(x, "x", torch.float32, (None, mlp.widths[0]), x.device)


def fused_mlp_forward(x: torch.Tensor, mlp: PackedMLP,
                      relu_tail: int = 0) -> torch.Tensor:
    """(B, d_in) float32 -> (B, d_out) float32 through an MLP packed with
    float32 or bf16 weights; relu on the last ``relu_tail`` outputs (the
    ClimSim surface scalars).  bf16 weights run the tensor-core kernel
    (float32 activations split into three bf16 parts, so the products are
    float32's), float32 weights the FMA kernel."""
    _check_mlp(x, mlp, (torch.float32, torch.bfloat16), relu_tail)
    if not _on_cuda(x, "fused_mlp_forward"):
        return fused_mlp_forward_plain(x, mlp, relu_tail)
    if mlp.w.dtype == torch.bfloat16:
        out = _launch_wgmma(x, mlp, relu_tail)
    else:
        out = _launch_mlp("fused_mlp_forward_f32", x, mlp, relu_tail)
    LAUNCHES["fused_mlp_forward"] += 1
    return out


def fused_mlp_forward_int8(x: torch.Tensor, mlp: PackedMLP,
                           relu_tail: int = 0) -> torch.Tensor:
    """``fused_mlp_forward`` for an MLP packed with ``weights_dtype="int8"``."""
    _check_mlp(x, mlp, (torch.int8,), relu_tail)
    if mlp.scale is None:
        raise ValueError("an int8-packed MLP needs its scales")
    if not _on_cuda(x, "fused_mlp_forward_int8"):
        return fused_mlp_forward_int8_plain(x, mlp, relu_tail)
    out = _launch_wgmma(x, mlp, relu_tail)
    LAUNCHES["fused_mlp_forward_int8"] += 1
    return out


def mlp_params_to_matrices(state_dict):
    """Ordered (weights (d_in, d_out), biases) of an OnlineMLP state_dict.

    A state_dict lists the layers in the order the modules were declared
    (trunk layers by index, then the head), so the order is the network's:
    no sort of key strings, which would put ``layers.10`` before
    ``layers.2``.
    """
    ws, bs = [], []
    for key, v in state_dict.items():
        if key.endswith(".weight"):
            ws.append(v.detach().t())   # nn.Linear (out, in) -> (in, out)
        elif key.endswith(".bias"):
            bs.append(v.detach())
    return ws, bs


# --------------------------------------------------------------------------
# int8 weight-only quantization for the fused MLP
# --------------------------------------------------------------------------
def quantize_weights_int8(weights):
    """Per-output-channel symmetric int8 quantization of (d_in, d_out)
    weights.

    Returns (q int8 list, scales float32 list); dequantized weight =
    q * scale[None, :].  Bit-identical to the reference's numpy version:
    the same float32 divisions, and torch.round rounds half to even as
    np.round does.
    """
    qs, scales = [], []
    for w in weights:
        w = _host_f32(w)
        s = w.abs().amax(dim=0) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        qs.append(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8))
        scales.append(s)
    return qs, scales
