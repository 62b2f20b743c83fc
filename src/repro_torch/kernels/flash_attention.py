"""GQA flash attention with position masks on the card (replaces the
reference's ``kernels/flash_attention.py:flash_attention`` and its
``kernels/ops.py:flash_attention`` wrapper).

Contract, in the model layout: q ``(B, Sq, H, D)``, k ``(B, Skv, K, D)``,
v ``(B, Skv, K, Dv)`` with ``H = K * G``, query head ``h`` reading KV head ``h // G``;
``q_positions (Sq,)`` and ``kv_positions (Skv,)`` int32.  Key ``s`` is
visible to query ``i`` when ``kv_positions[s] >= 0`` (a written cache
slot), and, if ``causal``, ``kv_positions[s] <= q_positions[i]``, and, if
``window > 0``, ``q_positions[i] - kv_positions[s] < window``: the masks
of the reference's ``naive_attention``.  The TPU kernel's wrapper drops
the positions and takes query ``i`` to sit at position ``i``, which is
wrong in decode; the kernels here take them.  fp32 inside, masked scores
at ``-1e30`` and the row sum floored at ``1e-30``, as in the TPU kernel.
Output ``(B, Sq, H, Dv)`` in q's dtype.  ``(D, Dv)`` is one of
:data:`HEAD_DIMS`: ``D == Dv`` for the GQA models, and MLA's ``nope +
rope`` against ``v_head_dim`` (deepseek-v2-lite 192 / 128, its smoke
config 24 / 16).

Three designs on the card, chosen by shape (see ``csrc/model_kernels.cu``
and ``csrc/attention_kernels.cu``):

* decode, ``Sq <= DECODE_MAX_SQ``, fp32 or bf16, every pair of head dims: a
  split-KV kernel (``flash_decode``), one block per (batch, KV head, row
  group, KV split) serving all ``G * Sq`` query rows of its KV head, then
  a combine kernel (``flash_decode_combine``) over the splits' partial
  ``(m, l, acc)``; :func:`decode_plan` picks the split count and
  :func:`flash_decode_plain` runs the same algorithm in plain PyTorch;
* prefill in bf16 at the head dims :data:`PREFILL_DIMS`: ``flash_prefill``,
  both products on the tensor cores with ``wgmma`` (bf16 operands, fp32
  accumulators, the probabilities split into two bf16 parts);
* the rest (fp32 prefill, bf16 prefill at D < 64): the SIMT kernel
  ``flash_simt``, fp32 FMAs on the CUDA cores.

``build.LAUNCHES["flash_attention"]`` counts calls of
:func:`flash_attention_cuda` (one a layer a step); each kernel counts its
own launches under its own name.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {"float32": 4, "bfloat16": 2}
# (D, Dv): q / k head dim, v head dim (FA_DIMS of csrc/model_kernels.cu)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256),
             (24, 16), (192, 128))
# the SIMT kernel (kFa* of csrc/model_kernels.cu)
THREADS = 128   # kFaThreads
Q_TILE = 64     # kFaRows: query rows of a block (twice: simt_rows)
KV_TILE = 32    # kFaKeys: keys of a K / V tile
LANES = 8       # kFaLanes: lanes of a row group

# the split-KV decode kernel (kFd* of csrc/model_kernels.cu)
DECODE_MAX_SQ = 16      # query rows per head that still count as decode
DECODE_ROWS = 16        # kFdRows: (query head, query) rows of one block
DECODE_TILE = 32        # kFdTile: keys staged per step
DECODE_THREADS = 128    # kFdThreads
COMBINE_THREADS = 256   # kFcThreads: one block per output row
SMS = 132               # streaming multiprocessors of an H100 SXM
BLOCKS_WANTED = 3 * SMS  # about three split blocks resident per SM

# the wgmma bf16 prefill kernel (kFp* of csrc/attention_kernels.cu)
PREFILL_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
PREFILL_ROWS = 64       # kFpRows: query rows of a block (one warpgroup)
PREFILL_KEYS = 64       # kFpKeys: keys of a K / V tile
PREFILL_THREADS = 128   # kFpThreads: one warpgroup


def visible(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """The ``(Sq, Skv)`` boolean mask of the contract."""
    qp, kp = q_positions[:, None], kv_positions[None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return m


def flash_attention_plain(q, k, v, q_positions, kv_positions, *,
                          causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch, in fp32, one softmax over
    all of ``Skv``."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qf = q.to(torch.float32).reshape(B, Sq, K, H // K, D) * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    m = visible(q_positions, kv_positions, causal=causal, window=window)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    mx = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_plan(B: int, Sq: int, H: int, K: int, Skv: int
                ) -> Tuple[int, int, int]:
    """``(row_groups, tiles_per_split, splits)`` of the split-KV decode
    kernel: the ``G * Sq`` rows of a KV head in groups of
    :data:`DECODE_ROWS`, and the ``Skv`` slots in splits of
    ``tiles_per_split`` tiles of :data:`DECODE_TILE` keys, as few tiles a
    split as still give about :data:`BLOCKS_WANTED` blocks in all
    (recurrentgemma-2b decode, B 4 x 1 KV head over 2048 slots: 64 splits
    of 32; lm100m, B 8 x 4 KV heads over 577: 10 splits of 64)."""
    rows = (H // K) * Sq
    groups = -(-rows // DECODE_ROWS)
    tiles = -(-Skv // DECODE_TILE)
    base = B * K * groups
    per_split = max(1, -(-tiles * base // BLOCKS_WANTED))
    return groups, per_split, -(-tiles // per_split)


def _tile_runs(q_positions, kv_positions, *, causal, window, tile):
    """Per key tile: does any pair of it survive the position-range test
    the kernels skip tiles by (any written slot; causal, its least
    position not after the last query; window, its latest position
    still inside the first query's window)."""
    Skv = kv_positions.numel()
    n = -(-Skv // tile)
    kp = torch.full((n * tile,), -1, dtype=torch.int64,
                    device=kv_positions.device)
    kp[:Skv] = kv_positions
    kp = kp.reshape(n, tile)
    written = kp >= 0
    hi = kp.amax(dim=1)
    lo = torch.where(written, kp, torch.full_like(kp, 2 ** 40)).amin(dim=1)
    qlo, qhi = int(q_positions.min()), int(q_positions.max())
    run = hi >= 0
    if causal:
        run = run & (lo <= qhi)
    if window > 0:
        run = run & (qlo - hi < window)
    return run


def decode_split_plain(q, k, v, q_positions, kv_positions, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None):
    """The split kernel's partials in plain PyTorch, fp32, in its scratch
    layout: ``(part_ml (B, Sq, H, splits, 2), part_acc (B, Sq, H, splits,
    Dv))``, each split's row max ``m`` and row sum ``l`` and unnormalised
    output ``acc`` over the tiles the position ranges do not rule out (a
    split with none: ``m = -1e30, l = 0, acc = 0``).  The kernel tests the
    ranges against its row group's queries, this against all ``Sq``: the
    two differ only on a row with no visible key, outside the contract's
    use."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    _, per_split, splits = decode_plan(B, Sq, H, K, Skv)
    chunk = per_split * DECODE_TILE
    n = splits * chunk
    qf = q.to(torch.float32).reshape(B, Sq, K, G, D) * scale
    kf = torch.zeros((B, n, K, D), dtype=torch.float32, device=q.device)
    vf = torch.zeros((B, n, K, Dv), dtype=torch.float32, device=q.device)
    kf[:, :Skv], vf[:, :Skv] = k.to(torch.float32), v.to(torch.float32)
    kp = torch.full((n,), -1, dtype=kv_positions.dtype,
                    device=kv_positions.device)
    kp[:Skv] = kv_positions
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, kf)
    s = torch.where(visible(q_positions, kp, causal=causal,
                            window=window)[:, None, None],
                    s, torch.full_like(s, NEG_INF))
    runs = _tile_runs(q_positions, kv_positions, causal=causal,
                      window=window, tile=DECODE_TILE)
    keep = torch.zeros((n,), dtype=torch.bool, device=q.device)
    keep[:Skv] = runs.repeat_interleave(DECODE_TILE)[:Skv]
    s = s.reshape(B, Sq, H, splits, chunk)
    keep = keep.reshape(splits, chunk)
    m = torch.where(keep, s, torch.full_like(s, -torch.inf)).amax(dim=-1)
    m = torch.clamp(m, min=NEG_INF)     # a split with nothing kept: -1e30
    p = torch.exp(s - m[..., None]) * keep
    acc = torch.einsum("bqkgtc,btckd->bqkgtd",
                       p.reshape(B, Sq, K, G, splits, chunk),
                       vf.reshape(B, splits, chunk, K, Dv))
    part_ml = torch.stack([m, p.sum(dim=-1)], dim=-1)
    return part_ml, acc.reshape(B, Sq, H, splits, Dv)


def decode_combine_plain(part_ml, part_acc, dtype) -> torch.Tensor:
    """The combine kernel in plain PyTorch: ``sum_s e^(m_s - M) acc_s /
    max(sum_s e^(m_s - M) l_s, 1e-30)`` with ``M = max_s m_s``, in
    ``dtype``."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    total = torch.clamp((w * l).sum(dim=-1), min=1e-30)
    return ((w[..., None] * part_acc).sum(dim=-2)
            / total[..., None]).to(dtype)


def flash_decode_plain(q, k, v, q_positions, kv_positions, *,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The split-KV decode kernels' algorithm in plain PyTorch, in fp32:
    the splits of :func:`decode_plan` (:func:`decode_split_plain`), then
    the log-sum-exp combine (:func:`decode_combine_plain`)."""
    return decode_combine_plain(
        *decode_split_plain(q, k, v, q_positions, kv_positions,
                            causal=causal, window=window, scale=scale),
        q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels load
    16 bytes a lane)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q, k, v, q_positions, kv_positions):
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.get_device()
    for name, t in (("q", q), ("k", k), ("v", v), ("q_positions",
                                                   q_positions),
                    ("kv_positions", kv_positions)):
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}; all "
                             f"must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; want one of float32, bfloat16")
    if (k.shape[0] != B or tuple(v.shape[:3]) != tuple(k.shape[:3])
            or k.shape[3] != D or H % K):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims {D}/{Dv}; the kernels "
                         f"take (D, Dv) in {HEAD_DIMS}")
    if tuple(q_positions.shape) != (Sq,) or \
            tuple(kv_positions.shape) != (Skv,):
        raise ValueError(f"flash_attention: positions "
                         f"{tuple(q_positions.shape)} / "
                         f"{tuple(kv_positions.shape)} for Sq={Sq}, "
                         f"Skv={Skv}")
    if min(B, Sq, Skv) == 0:
        raise ValueError("flash_attention: empty input")


def design(Sq: int, D: int, dtype, dv: Optional[int] = None) -> str:
    """The kernel :func:`flash_attention_cuda` runs for ``Sq`` queries at
    head dims ``D`` (q, k) and ``dv`` (v; default ``D``) in ``dtype``:
    ``flash_decode``, ``flash_prefill`` or ``flash_simt``."""
    if Sq <= DECODE_MAX_SQ:
        return "flash_decode"
    if str(dtype).removeprefix("torch.") == "bfloat16" and \
            (D, D if dv is None else dv) in PREFILL_DIMS:
        return "flash_prefill"
    return "flash_simt"


def decode_split(q, k, v, qp, kp, *, causal, window, scale, out=None):
    """Launch the split kernel: ``(part_ml, part_acc)``, the splits' fp32
    ``(m, l)`` pairs ``(B, Sq, H, splits, 2)`` and accumulators ``(B, Sq,
    H, splits, Dv)``.  Given ``out`` (``(B, Sq, H, Dv)`` in q's dtype), the
    same host call launches the combine into it as well."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    groups, per_split, splits = decode_plan(B, Sq, H, K, Skv)
    n = B * Sq * H * splits
    scratch = torch.empty(n * (Dv + 2), dtype=torch.float32, device=q.device)
    part_acc = scratch[:n * Dv].view(B, Sq, H, splits, Dv)   # 16-B aligned
    part_ml = scratch[n * Dv:].view(B, Sq, H, splits, 2)
    build.launch("flash_decode", q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
                 part_ml.data_ptr(), part_acc.data_ptr(),
                 None if out is None else out.data_ptr(), _DTYPES[q.dtype],
                 B, Sq, Skv, H, K, D, Dv, groups, per_split, splits,
                 int(causal), int(window), float(scale))
    if out is not None:
        build.LAUNCHES["flash_decode_combine"] += 1
    return part_ml, part_acc


def decode_combine(part_ml, part_acc, dtype) -> torch.Tensor:
    """Launch the combine kernel over :func:`decode_split`'s partials:
    the ``(B, Sq, H, Dv)`` output in ``dtype``."""
    B, Sq, H, splits, D = part_acc.shape
    out = torch.empty((B, Sq, H, D), dtype=dtype, device=part_acc.device)
    build.launch("flash_decode_combine", part_acc.device,
                 part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
                 _DTYPES[dtype], B * Sq * H, splits, D)
    return out


def flash_attention_cuda(q, k, v, q_positions, kv_positions, *,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel :func:`design` picks (fp32 or bf16 q/k/v of one
    dtype, ``(D, Dv)`` in :data:`HEAD_DIMS`)."""
    _check(q, k, v, q_positions, kv_positions)
    B, Sq, H, D = q.shape
    Skv, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    qp = q_positions.to(torch.int32).contiguous()
    kp = kv_positions.to(torch.int32).contiguous()
    kind = design(Sq, D, q.dtype, Dv)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if kind == "flash_decode":
        decode_split(q, k, v, qp, kp, causal=causal, window=window,
                     scale=scale, out=out)
    else:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
                kp.data_ptr(), out.data_ptr())
        if kind == "flash_prefill":
            build.launch("flash_prefill", q.device, *args, B, Sq, Skv, H, K,
                         D, Dv, int(causal), int(window), float(scale))
        else:
            build.launch("flash_simt", q.device, *args, _DTYPES[q.dtype], B,
                         Sq, Skv, H, K, D, Dv, int(causal), int(window),
                         float(scale))
    build.LAUNCHES["flash_attention"] += 1
    return out


# -- launch specs (what each C launcher does, for the tile lint) ----------

def simt_smem(D: int, Skv: int, dtype: str = "float32",
              dv: Optional[int] = None, rows: Optional[int] = None) -> int:
    """``fa_smem_bytes<T, D, DV>(rows, ntiles)``: the q tile (``rows``,
    default :func:`simt_rows`) and its probabilities in fp32, the
    two-stage K and V ring in ``dtype`` (rows padded by four values), then
    a byte per KV tile, rounded up to 16."""
    dv = D if dv is None else dv
    rows = simt_rows(D, dtype, dv) if rows is None else rows
    ntiles = -(-Skv // KV_TILE)
    return 4 * rows * (D + 4 + KV_TILE + 4) \
        + 2 * KV_TILE * (D + 4 + dv + 4) * _ITEMSIZE[dtype] \
        + -(-ntiles // 16) * 16


def simt_rows(D: int, dtype: str = "float32",
              dv: Optional[int] = None) -> int:
    """``fa_rows<T, D, DV>()``: a SIMT block's query rows, ``2 * Q_TILE``
    (on ``2 * THREADS`` threads) where a block of ``Q_TILE`` rows would
    have its SM to itself and the taller one still fits (fp32 at MLA's
    192 / 128), else ``Q_TILE``."""
    narrow = simt_smem(D, 1024 * KV_TILE, dtype, dv, Q_TILE)
    tall = simt_smem(D, 1024 * KV_TILE, dtype, dv, 2 * Q_TILE)
    return 2 * Q_TILE if 2 * (narrow + 1024) > 233472 and tall <= 232448 \
        else Q_TILE


def decode_smem(D: int, dtype: str, dv: Optional[int] = None) -> int:
    """``fd_smem_bytes<T, D, DV>()``: the K tile (rows padded by 16
    bytes) and the V tile in ``dtype``, then the fp32 scores, ``m``,
    ``l``, ``alpha``, the rows' and keys' positions and the tile's
    position range (the q rows sit in registers)."""
    dv = D if dv is None else dv
    return (DECODE_TILE * (D + dv) * _ITEMSIZE[dtype] + 16 * DECODE_TILE
            + 4 * (DECODE_ROWS * DECODE_TILE + 4 * DECODE_ROWS
                   + DECODE_TILE + 2))


def prefill_smem(D: int, Skv: int, dv: Optional[int] = None) -> int:
    """``fp_smem_bytes(D, DV, Skv)``: the bf16 Q, K (``D`` wide) and V
    (``Dv`` wide) tiles in 128-byte swizzled 64-column blocks, 1024 bytes
    to align them, and one int per key tile (run / masked / full)."""
    dv = D if dv is None else dv
    return PREFILL_ROWS * (2 * D + dv) * 2 + 1024 \
        + 4 * -(-Skv // PREFILL_KEYS)


def launch_spec(q_shape, k_shape, dtype: str = "float32",
                dv: Optional[int] = None) -> build.LaunchSpec:
    """The launch of the kernel :func:`flash_attention_cuda` runs for q
    ``(B, Sq, H, D)``, k ``(B, Skv, K, D)`` and v ``(B, Skv, K, dv)``
    (``dv`` default ``D``) of ``dtype`` (for decode, the split kernel;
    :func:`combine_launch_spec` is the second)."""
    B, Sq, H, D = q_shape
    Skv, K = k_shape[1], k_shape[2]
    dv = D if dv is None else dv
    G = H // K
    kind = design(Sq, D, dtype, dv)
    kv = (B, Skv, K, D)
    vv = (B, Skv, K, dv)
    out = (B, Sq, H, dv)
    if kind == "flash_decode":
        groups, per_split, splits = decode_plan(B, Sq, H, K, Skv)
        chunk = per_split * DECODE_TILE
        rows = min(G * Sq, DECODE_ROWS)
        part = (B, Sq, H, splits)
        return build.LaunchSpec(
            kernel="flash_decode", source=build.source("model_kernels"),
            function="flash_decode_kernel", grid=(splits, K * groups, B),
            threads=DECODE_THREADS, smem=decode_smem(D, dtype, dv),
            operands=(
                build.Operand("q", tuple(q_shape), (1, Sq, rows // Sq, D),
                              dtype),
                build.Operand("k", kv, (1, chunk, 1, D), dtype),
                build.Operand("v", vv, (1, chunk, 1, dv), dtype),
                build.Operand("q_positions", (Sq,), (Sq,), "int32"),
                build.Operand("kv_positions", (Skv,), (chunk,), "int32"),
                build.Operand("part_ml", part + (2,),
                              (1, Sq, rows // Sq, 1, 2), "float32"),
                build.Operand("part_acc", part + (dv,),
                              (1, Sq, rows // Sq, 1, dv), "float32")),
            accumulator="acc", template={"T": dtype},
            threads_of="kFdThreads",
            constants={"kFdThreads": DECODE_THREADS, "kFdRows": DECODE_ROWS,
                       "kFdTile": DECODE_TILE})
    rows, keys = (PREFILL_ROWS, PREFILL_KEYS) if kind == "flash_prefill" \
        else (simt_rows(D, dtype, dv), KV_TILE)
    operands = (build.Operand("q", tuple(q_shape), (1, rows, 1, D), dtype),
                build.Operand("k", kv, (1, keys, 1, D), dtype),
                build.Operand("v", vv, (1, keys, 1, dv), dtype),
                build.Operand("q_positions", (Sq,), (rows,), "int32"),
                build.Operand("kv_positions", (Skv,), (keys,), "int32"),
                build.Operand("out", out, (1, rows, 1, dv), dtype))
    if kind == "flash_prefill":
        return build.LaunchSpec(
            kernel="flash_prefill", source=build.source("attention_kernels"),
            function="flash_prefill_kernel", grid=(-(-Sq // rows), H, B),
            threads=PREFILL_THREADS, smem=prefill_smem(D, Skv, dv),
            operands=operands, accumulator="o", threads_of="kFpThreads",
            constants={"kFpThreads": PREFILL_THREADS, "kFpRows": rows,
                       "kFpKeys": keys})
    # the q tiles on the grid's slowest axis (launched in reverse: the
    # most keys first)
    return build.LaunchSpec(
        kernel="flash_simt", source=build.source("model_kernels"),
        function="flash_attention_kernel", grid=(H, B, -(-Sq // rows)),
        threads=THREADS * rows // Q_TILE, smem=simt_smem(D, Skv, dtype, dv),
        operands=operands, accumulator="acc", template={"T": dtype},
        threads_of=f"kFaThreads * {rows // Q_TILE}",
        constants={"kFaThreads": THREADS, "kFaRows": Q_TILE,
                   "kFaKeys": keys, "kFaLanes": LANES})


def combine_smem(splits: int) -> int:
    """``fc_smem_bytes(splits)``: the splits' weights, the split groups'
    partial sums of a row, the warps' partial max and sum, fp32."""
    return 4 * (splits + 4 * COMBINE_THREADS + 2 * (COMBINE_THREADS // 32))


def combine_launch_spec(q_shape, k_shape, dtype: str = "float32",
                        dv: Optional[int] = None) -> build.LaunchSpec:
    """The combine launch of decode: one block per output row ``(b, sq,
    h)``, its threads over the row's ``dv`` columns (a float4 each; ``dv``
    default ``D``) and its splits."""
    B, Sq, H, D = q_shape
    D = D if dv is None else dv
    Skv, K = k_shape[1], k_shape[2]
    splits = decode_plan(B, Sq, H, K, Skv)[2]
    rows = B * Sq * H
    return build.LaunchSpec(
        kernel="flash_decode_combine", source=build.source("model_kernels"),
        function="flash_decode_combine_kernel", grid=(rows, 1, 1),
        threads=COMBINE_THREADS, smem=combine_smem(splits),
        operands=(build.Operand("part_ml", (rows, splits, 2),
                                (1, splits, 2), "float32"),
                  build.Operand("part_acc", (rows, splits, D),
                                (1, splits, D), "float32"),
                  build.Operand("out", (rows, D), (1, D), dtype)),
        accumulator="acc", template={"T": dtype}, threads_of="kFcThreads",
        constants={"kFcThreads": COMBINE_THREADS})


# -- cost (what a call does, for the counter and the bound) ---------------

def visible_counts(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   *, causal: bool, window: int) -> Tuple[int, int]:
    """``(pairs, seen)``: the (query, key) pairs the contract's mask lets
    through, and the key slots some query sees, read off the positions
    by sorting and binary search (no ``(Sq, Skv)`` mask: at 32k x 32k
    that would be a gigabyte)."""
    kp = kv_positions.to(torch.int64)
    keys = torch.sort(kp[kp >= 0]).values
    qs = torch.sort(q_positions.to(torch.int64)).values
    if keys.numel() == 0 or qs.numel() == 0:
        return 0, 0
    big = torch.iinfo(torch.int64).max // 4
    hi = qs if causal else torch.full_like(qs, big)
    lo = qs - window + 1 if window > 0 else torch.full_like(qs, -big)
    pairs = (torch.searchsorted(keys, hi, right=True)
             - torch.searchsorted(keys, lo)).clamp(min=0).sum()
    # a key k is seen when some query q has (not causal or k <= q) and
    # (no window or q < k + window)
    first = keys if causal else torch.full_like(keys, -big)
    last = keys + window - 1 if window > 0 else torch.full_like(keys, big)
    seen = ((torch.searchsorted(qs, last, right=True)
             - torch.searchsorted(qs, first)) > 0).sum()
    return int(pairs), int(seen)


@functools.lru_cache(maxsize=64)
def assumed_counts(Sq: int, Skv: int, *, causal: bool, window: int
                   ) -> Tuple[int, int]:
    """:func:`visible_counts` where a ``meta`` tensor holds no positions:
    every key slot written at positions ``0..Skv-1`` and the queries the
    last ``Sq`` of them, as in a dry run's cells (a prompt into a cache of
    its own length, a decode step at the last slot of a full cache, a
    ring of the window's width)."""
    return visible_counts(torch.arange(Skv - Sq, Skv), torch.arange(Skv),
                          causal=causal, window=window)


def cost(q_shape, k_shape, dtype, dv: Optional[int] = None, *, pairs: int,
         seen: int) -> Tuple[int, int]:
    """``(operations, bytes)`` of one call at q ``(B, Sq, H, D)``, k ``(B,
    Skv, K, D)`` and v of head dim ``dv`` (default ``D``) in ``dtype``, with
    ``pairs`` visible (query, key) pairs a head and ``seen`` key slots
    some query sees (:func:`visible_counts`): ``2 (D + Dv)`` operations a
    visible pair and head; q, the seen keys and values and the output
    moved once, and both positions arrays."""
    B, Sq, H, D = q_shape
    Skv, K = k_shape[1], k_shape[2]
    dv = D if dv is None else dv
    size = dtype.itemsize if isinstance(dtype, torch.dtype) \
        else _ITEMSIZE[dtype]
    flops = 2 * B * H * pairs * (D + dv)
    moved = (B * Sq * H * (D + dv) + B * seen * K * (D + dv)) * size \
        + (Sq + Skv) * 4
    return flops, moved
