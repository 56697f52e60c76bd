"""QuartetLinear: the fully-NVFP4 linear layer (paper Fig. 3), forward and
backward, parameterized by a Scheme.

Counterpart of `repro/core/linear.py`. Simulated-NVFP4 GEMM semantics: the
GEMM consumes "block values" (fp4_code * e4m3_scale, exactly representable
in bf16 because 2 + 4 significant bits < 8), accumulates in fp32, and the two
per-tensor FP32 scales multiply the GEMM output.

Backward orientation (inner dims):
    Y  = X  @ W^T    inner K   (forward quantizers, groups along K)
    dX = E  @ W      inner N   (E rows and W^T rows quantized along N)
    dW = E^T @ X     inner M   (E^T and X^T quantized along M = batch*seq)

`qlinear` on a raw weight is a `torch.autograd.Function`, the counterpart of
the reference's `_qlinear_cvjp`. Activations are saved for the backward as
packed NVFP4 (4.5 bits/element) whenever the forward quantizes them.

On a CUDA device the 4/6 quantizer, the NVFP4 GEMM and the two MS-EDEN
requant phases run as the port's hand-written kernels (`kernels/ops.py`); on
the CPU as their plain versions. One deliberate difference from the
reference: under `bwd == "ms_eden"` each backward GEMM is
`ops.quartet2_backward_gemm`, the post-hoc (two-phase) MS-EDEN of the
reference's kernel path, where the reference's `qlinear` runs the direct
Algorithm 1 in plain jnp. The two are statistically equivalent (both
unbiased, MSE within 10%; `core/ms_eden.py`). Randomness comes from
`core/rng.py` (the reference's threefry is not re-implemented), so the port
is held bitwise against the reference only with injected draws.

Left out, and so absent here: the GSPMD sharding hints of the reference
(`_hint` and friends, a no-op off-mesh).

fp32 matmuls here are IEEE fp32, as XLA's are on the CPU: the package turns
TF32 off when it is imported (`repro_torch/__init__.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.core import rht as R
from repro_torch.core import rng
from repro_torch.core import schemes as S
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ms_eden_requant as MR
from repro_torch.kernels import ops


class PackedQWeight(NamedTuple):
    """An offline-packed NVFP4 weight: 4.5 bits/element at rest.

    `packed` holds E2M1 codes (2/byte, low nibble = even index),
    `scale_bits` the e4m3 group scales as raw bits — both produced by the
    same quantizer the per-step path runs — so the GEMM sees exactly the
    per-step operands. Stacked-layer stacks index per layer with `layer(l)`.
    """

    packed: torch.Tensor      # uint8 (..., N, K // 2)
    scale_bits: torch.Tensor  # uint8 (..., N, K // 16): raw e4m3 bits
    gscale: torch.Tensor      # float32 (...,) per-tensor scale

    @property
    def out_features(self) -> int:
        return self.packed.shape[-2]

    def layer(self, i: int) -> "PackedQWeight":
        """Layer i of a stacked (L, N, K/2) weight (views, no copy)."""
        return PackedQWeight(self.packed[i], self.scale_bits[i], self.gscale[i])


def _quant_packed(x: torch.Tensor, kind: str):
    """Forward quantizer `kind` of a 2-D tensor, in the packed operand form
    (codes, scale bits, gscale) that `fp4_matmul` consumes."""
    if kind == "fos":
        return ops.nvfp4_fos_quant(x.contiguous())
    if kind == "rtn":
        return _pack_qt(Q.quant_rtn(x, s=Q.S_EDEN))
    if kind == "square":
        return _pack_qt(Q.quant_square_block(x))
    raise ValueError(f"unknown forward quantizer {kind}")


def _pack_qt(qt: Q.QTensor):
    return F.pack_fp4(qt.codes), F.e4m3_to_bits(qt.scales), qt.gscale


def _dequant_packed(p, s, g, dtype=torch.bfloat16) -> torch.Tensor:
    return (FM.block_values(p, s) * g).to(dtype)


def _qmm(qa, qb, out_dtype=torch.float32) -> torch.Tensor:
    """Simulated NVFP4 GEMM: (Ma, D) x (Mb, D) -> (Ma, Mb), fp32 accumulation;
    out_dtype f32, or bf16 rounded from the f32 result by the GEMM itself."""
    return ops.fp4_matmul(qa[0], qa[1], qb[0], qb[1], qa[2], qb[2], out_dtype)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 GEMM (Ma, D) x (Mb, D) -> (Ma, Mb), fp32 accumulation: an fp32
    matmul of bf16-exact values (never a bf16-output matmul)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T


def pack_weight(w: torch.Tensor, kind: str) -> PackedQWeight:
    """Quantize one 2-D weight with forward quantizer `kind` and pack it."""
    return PackedQWeight(*_quant_packed(w, kind))


def _qlinear_packed(x: torch.Tensor, w: PackedQWeight, scheme: str):
    """Inference forward against a prequantized weight: bit-identical to the
    per-step path on the raw weight (activations still quantize per call)."""
    sch = S.get(scheme)
    assert sch.fwd_w != "none", \
        f"scheme {scheme} does not quantize weights; pass the raw array"
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1])
    qw = (w.packed, w.scale_bits, w.gscale)
    if sch.fwd_x != "none":
        y = _qmm(_quant_packed(xf, sch.fwd_x), qw, x.dtype)
    else:
        y = _mm(xf, _dequant_packed(*qw))
    return y.to(x.dtype).reshape(*lead, -1)


def quant_sr_fos(x: torch.Tensor, u: torch.Tensor) -> Q.QTensor:
    """FourOverSix backward quantizer: the forward's deterministic 4/6
    branch choice, then SR against uniforms u (x's shape). Both the branch
    choice and the SR through clipping are biased (paper Sec. 4.2, App. A)."""
    gscale, scales, xs = Q.four_over_six_branch(x.float())
    return Q.QTensor(F.fp4_sr(xs, u), scales, gscale)


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the last axis to a multiple of `mult` (safe for GEMM sums)."""
    pad = (-x.shape[-1]) % mult
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def _operand(x: torch.Tensor, mult: int) -> torch.Tensor:
    """A backward GEMM operand as the quantizers take it: f32, the inner dim
    padded to `mult`. Without padding an f32 operand stays the view it is
    when MS-EDEN phase 1 reads it in place (row-major, or the transpose of a
    row-major tensor: E^T, W^T, X^T); otherwise a contiguous copy."""
    x = _pad_to(x, mult).float()
    return x if MR.layout(x) is not None else x.contiguous()


def _sr_uniforms(draws, tag: int, shape, x: torch.Tensor):
    """MS-EDEN phase 2's SR uniforms of `tag` for operand x: the tag's key
    pair when the draws are hashed (phase 2 hashes each group's index
    itself, and no uniform tensor is made), else the draws object's own
    tensor (the tests inject the reference's draws this way)."""
    if isinstance(draws, rng.HashDraws):
        return draws.keys(tag)
    return draws.uniform(tag, shape, x.device)


def _bwd_gemm(a, b, bwd: str, quant_a: bool, quant_b: bool, use_rht: bool,
              draws, tag: int) -> torch.Tensor:
    """One backward GEMM a @ b^T (a (Ma, D), b (Mb, D)) with per-scheme
    quantization on the inner dim D; f32 (Ma, Mb)."""
    if not (quant_a or quant_b):
        return _mm(a, b)
    mult = 128 if a.shape[-1] % 128 else 16  # pad target for groups/rotation
    a = _operand(a, mult if use_rht else 16)
    b = _operand(b, mult if use_rht else 16)
    d = a.shape[-1]
    groups = d // F.GROUP

    if bwd == "ms_eden":
        if not (quant_a and quant_b and use_rht):
            raise ValueError("MS-EDEN requires re-quantizing both operands")
        signs = draws.signs(tag, R.block_size(d), a.device)
        return ops.quartet2_backward_gemm(
            a, b, signs, _sr_uniforms(draws, tag + 1, (a.shape[0], groups), a),
            _sr_uniforms(draws, tag + 2, (b.shape[0], groups), b))

    quantizer = Q.quant_sr if bwd == "sr" else quant_sr_fos
    if use_rht and quant_a and quant_b:
        signs = draws.signs(tag, R.block_size(d), a.device)
        a, b = R.rht(a, signs), R.rht(b, signs)
    if quant_a and quant_b:
        qa = quantizer(a, draws.uniform(tag + 1, a.shape, a.device))
        qb = quantizer(b, draws.uniform(tag + 2, b.shape, b.device))
        return _qmm(_pack_qt(qa), _pack_qt(qb))
    if quant_a:
        qa = quantizer(a, draws.uniform(tag + 1, a.shape, a.device))
        return _mm(Q.dequant(qa, torch.bfloat16), b)
    qb = quantizer(b, draws.uniform(tag + 2, b.shape, b.device))
    return _mm(a, Q.dequant(qb, torch.bfloat16))


def qlinear(x: torch.Tensor, w, seed=None, scheme: str = "quartet2"):
    """y = x @ w^T under the given quantization scheme.

    x: (..., K) activations; w: (N, K) weight — raw tensor (training, with
    the scheme's backward) or PackedQWeight (quantize-once serving); seed: a
    uint32[2] site seed for the stochastic backward, or an object with the
    draw methods of `core.rng.HashDraws` (tests pass the reference's draws).
    """
    if isinstance(w, PackedQWeight):
        return _qlinear_packed(x, w, scheme)
    return _QLinear.apply(x, w, seed, scheme)


class _QLinear(torch.autograd.Function):
    """The counterpart of the reference's `_qlinear_cvjp` / `_qlinear_fwd` /
    `_qlinear_bwd`."""

    @staticmethod
    def forward(ctx, x, w, seed, scheme):
        sch = S.get(scheme)
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1])
        ctx.scheme, ctx.seed, ctx.x_shape = scheme, seed, x.shape
        if not sch.is_quantized:
            ctx.save_for_backward(xf, w)
            return _mm(xf, w).to(x.dtype).reshape(*lead, -1)
        qx = _quant_packed(xf, sch.fwd_x) if sch.fwd_x != "none" else None
        qw = _quant_packed(w, sch.fwd_w) if sch.fwd_w != "none" else None
        if qx is not None and qw is not None:
            y = _qmm(qx, qw, x.dtype)
        elif qx is not None:
            y = _mm(_dequant_packed(*qx), w)
        elif qw is not None:
            y = _mm(xf, _dequant_packed(*qw))
        else:
            y = _mm(xf, w)
        # the backward re-quantizes the SAVED quantized activations (paper
        # Sec. 5); W's packed image is saved too, bit-identical to the
        # reference's re-run of the deterministic forward quantizer
        ctx.quant_x, ctx.quant_w = qx is not None, qw is not None
        ctx.save_for_backward(*(qx if qx is not None else (xf,)), w,
                              *(qw if qw is not None else ()))
        return y.to(x.dtype).reshape(*lead, -1)

    @staticmethod
    def backward(ctx, e):
        sch = S.get(ctx.scheme)
        saved = ctx.saved_tensors
        n_x = 3 if getattr(ctx, "quant_x", False) else 1
        x_res, w, qw = saved[:n_x], saved[n_x], saved[n_x + 1:]
        n, k = w.shape
        ef = e.reshape(-1, n)
        xf = (_dequant_packed(*x_res, dtype=torch.float32) if n_x == 3
              else x_res[0].float())

        if not sch.is_quantized or sch.bwd == "none":
            dx = _mm(ef, w.T)
            dw = _mm(ef.T, xf.T)
        else:
            draws = rng.draws(ctx.seed)
            # one f32 image of E serves both GEMMs (E and its transpose
            # view); every use below reads E through f32 or bf16, exactly
            ef = ef.float()
            # ---- dX = E @ W (inner dim N) ----
            if sch.quant_dx_e:
                if sch.dx_w_mode == "requant":
                    w_saved = (_dequant_packed(*qw, dtype=torch.float32)
                               if qw else w.float())
                    dx = _bwd_gemm(ef, w_saved.T, sch.bwd, True, True,
                                   use_rht=True, draws=draws, tag=1)
                elif sch.dx_w_mode == "reuse":
                    if sch.fwd_w != "square":
                        raise ValueError("scale reuse needs square blocks")
                    dx = _bwd_gemm(ef, _dequant_packed(*qw).T, sch.bwd, True,
                                   False, use_rht=False, draws=draws, tag=1)
                else:  # "bf16"
                    dx = _bwd_gemm(ef, w.T.float(), sch.bwd, True, False,
                                   use_rht=False, draws=draws, tag=1)
            else:
                dx = _mm(ef, w.T)
            # ---- dW = E^T @ X (inner dim M) ----
            if sch.quant_dw_e or sch.quant_dw_x:
                dw = _bwd_gemm(ef.T, xf.T, sch.bwd, sch.quant_dw_e,
                               sch.quant_dw_x, use_rht=sch.rht_dw,
                               draws=draws, tag=4)
            else:
                dw = _mm(ef.T, xf.T)
        dx = dx.reshape(ctx.x_shape).to(e.dtype)
        return dx, dw.to(w.dtype), None, None


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain bf16 linear (LM head): bf16 operands, fp32 accumulation, output
    in x.dtype."""
    out = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    return out.to(x.dtype)
