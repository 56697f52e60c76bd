"""Recipe registry: which quantizer touches which tensor of which GEMM.

A copy of the JAX package's `core/schemes.py` table (the port keeps its own).

A `Scheme` describes the full linear-layer computation graph of one training
recipe (paper Section 5 + Figure 1 ablations + Section 2 baselines):

forward  Y = Qf(X) @ Qf(W)^T                      (inner dim K)
backward dX = Qb(E) @ Qb(W^T)^T                   (inner dim N)
         dW = Qb(E^T) @ Qb(X^T)^T                 (inner dim M)

RHT is applied on the inner dimension of a backward GEMM whenever BOTH of its
operands are (re)quantized (paper Section 6.1), with a shared seed so the
rotations cancel inside the dot product.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Scheme:
    name: str
    # forward quantizers: "none" | "rtn" | "fos" (four-over-six) | "square"
    fwd_x: str = "none"
    fwd_w: str = "none"
    # backward quantizer family: "none" | "sr" | "sr_fos" | "ms_eden"
    bwd: str = "none"
    # dX GEMM: quantize E? and how to treat W^T:
    #   "bf16"    - keep W in bf16 (Fig. 1 b/d)
    #   "reuse"   - reuse the forward QTensor without re-quantization (NVIDIA;
    #               requires fwd_w == "square" for orientation-correct scales)
    #   "requant" - de-quantize the saved forward W and re-quantize along N
    quant_dx_e: bool = False
    dx_w_mode: str = "requant"
    # dW GEMM: quantize E^T / X^T?
    quant_dw_e: bool = False
    quant_dw_x: bool = False

    @property
    def is_quantized(self) -> bool:
        return self.fwd_x != "none" or self.fwd_w != "none" or self.bwd != "none"

    @property
    def rht_dx(self) -> bool:
        """RHT on the dX GEMM iff both operands are freshly quantized."""
        return self.quant_dx_e and self.dx_w_mode == "requant" and self.bwd != "none"

    @property
    def rht_dw(self) -> bool:
        return self.quant_dw_e and self.quant_dw_x and self.bwd != "none"


_REGISTRY: dict[str, Scheme] = {}


def register(s: Scheme) -> Scheme:
    _REGISTRY[s.name] = s
    return s


def get(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheme '{name}'; have {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# --- end-to-end recipes ----------------------------------------------------

BF16 = register(Scheme(name="bf16"))

# NVIDIA et al. (2025): square-block W on forward (reused un-re-quantized in
# the dX GEMM, hence no RHT there), RHT+SR on the dW GEMM.
NVIDIA = register(Scheme(
    name="nvidia", fwd_x="rtn", fwd_w="square", bwd="sr",
    quant_dx_e=True, dx_w_mode="reuse", quant_dw_e=True, quant_dw_x=True,
))

# TetraJet-v2 as operationalized by the paper (Section 2): native-1x16 RTN
# forward, SR + inner-dim RHT with re-quantization on both backward GEMMs.
TETRAJET_V2 = register(Scheme(
    name="tetrajet_v2", fwd_x="rtn", fwd_w="rtn", bwd="sr",
    quant_dx_e=True, dx_w_mode="requant", quant_dw_e=True, quant_dw_x=True,
))

# FourOverSix (Cook et al. 2025): 4/6 forward; their backward combines 4/6
# grid selection with SR -> biased (paper Section 4.2 / Appendix A).
FOUR_OVER_SIX = register(Scheme(
    name="four_over_six", fwd_x="fos", fwd_w="fos", bwd="sr_fos",
    quant_dx_e=True, dx_w_mode="requant", quant_dw_e=True, quant_dw_x=True,
))

# Quartet II (this paper): 4/6 RTN forward with native scales; MS-EDEN with
# weight re-quantization on both backward GEMMs.
QUARTET2 = register(Scheme(
    name="quartet2", fwd_x="fos", fwd_w="fos", bwd="ms_eden",
    quant_dx_e=True, dx_w_mode="requant", quant_dw_e=True, quant_dw_x=True,
))

# Forward-pass-only ablations (paper Figure 2).
register(Scheme(name="fwd_rtn_1x16", fwd_x="rtn", fwd_w="rtn"))
register(Scheme(name="fwd_rtn_1x16_fos", fwd_x="fos", fwd_w="fos"))
register(Scheme(name="fwd_square", fwd_x="rtn", fwd_w="square"))
# 4/6 on activations only: square W scales don't benefit from 4/6 (Table 1).
register(Scheme(name="fwd_square_fos", fwd_x="fos", fwd_w="square"))

# Backward-pass-only ablations (paper Figure 1 (a)-(e)); forward stays bf16.
# "sr_fos" (4/6 + SR) is included for the App.-A bias demonstration (Fig. 9).
for q in ("sr", "ms_eden", "sr_fos"):
    register(Scheme(  # (a) dW GEMM only
        name=f"abl_a_{q}", bwd=q, quant_dw_e=True, quant_dw_x=True))
    if q == "sr":  # (b)/(d) keep W in bf16 -> MS-EDEN inapplicable (Sec. 6.1)
        register(Scheme(  # (b) dX only, W in bf16
            name=f"abl_b_{q}", bwd=q, quant_dx_e=True, dx_w_mode="bf16"))
        register(Scheme(  # (d) both GEMMs, W in bf16
            name=f"abl_d_{q}", bwd=q, quant_dx_e=True, dx_w_mode="bf16",
            quant_dw_e=True, quant_dw_x=True))
    register(Scheme(  # (c) dX only, W re-quantized
        name=f"abl_c_{q}", bwd=q, quant_dx_e=True, dx_w_mode="requant"))
    register(Scheme(  # (e) both GEMMs, W re-quantized
        name=f"abl_e_{q}", bwd=q, quant_dx_e=True, dx_w_mode="requant",
        quant_dw_e=True, quant_dw_x=True))


def variant(base: str, **kw) -> Scheme:
    """Derive an unregistered one-off scheme from a registered one."""
    return replace(get(base), name=f"{base}:{','.join(f'{k}={v}' for k, v in kw.items())}", **kw)
