"""The work of one launch of the gated-delta-rule decode kernel
(``gdn_decode``: one GDN layer's T = 1 step over ``rows`` rows).

Bytes, each once: the fp32 recurrent state read and written (``Hv · Dk ·
Dv`` a row), the conv state read and written (``K - 1`` inputs of the ``C
= 2·Hk·Dk + Hv·Dv`` channels a row, ``conv_bytes`` each), the row's inputs
(q, k, v and z of the projection, b and a) and its output (``Hv · Dv``) in
the model dtype, the conv weights, ``A_log``, ``dt_bias`` and the norm's
scale.  Operations a row: the conv (``2·C·K``) and, a value head, the
decay, the two column sums ``Sᵀk`` and ``Sᵀq`` and the rank-one update
(``7 · Dk · Dv``); the state's bytes bound it by two orders of magnitude."""

# kernel names in the profiler's trace
KERNELS = ("gdn_decode",)


def work(rows: int, k_heads: int, v_heads: int, dk: int, dv: int, conv: int,
         conv_bytes: int = 2, act_bytes: int = 2):
    """→ (FLOPs, bytes) of one launch."""
    channels = 2 * k_heads * dk + v_heads * dv
    state = rows * v_heads * dk * dv * 4
    conv_state = rows * (conv - 1) * channels * conv_bytes
    inputs = rows * (channels + v_heads * dv + 2 * v_heads) * act_bytes
    params = channels * conv * act_bytes + 2 * v_heads * 4 + dv * 4
    out = rows * v_heads * dv * act_bytes
    flops = rows * (2 * channels * conv + 7 * v_heads * dk * dv)
    return flops, 2 * state + 2 * conv_state + inputs + params + out
