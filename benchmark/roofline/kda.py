"""The work of one launch of the Kimi Delta Attention decode kernel
(``kda_decode``: one KDA layer's T = 1 step over ``rows`` rows).

Bytes, each once: the fp32 recurrent state read and written (``H · Dk ·
Dv`` a row), the conv state read and written (``K - 1`` inputs of the ``C
= 3·H·D`` channels a row, ``conv_bytes`` each), the row's inputs (q, k and
v before the conv, the decay's projection f and the output gate's og, ``H ·
D`` each, and b, ``H``) and its output (``H · Dv``) in the model dtype, the
conv weights, ``A_log``, ``dt_bias`` (a channel) and the norm's scale.
Operations a row: the conv (``2·C·K``) and, a head, the decay, the two
column sums ``Sᵀk`` and ``Sᵀq`` and the rank-one update (``7 · Dk · Dv``);
the state's bytes bound it by two orders of magnitude."""

# kernel names in the profiler's trace
KERNELS = ("kda_decode",)


def work(rows: int, heads: int, dk: int, dv: int, conv: int, conv_bytes: int = 2,
         act_bytes: int = 2):
    """→ (FLOPs, bytes) of one launch."""
    channels = 3 * heads * dk
    state = rows * heads * dk * dv * 4
    conv_state = rows * (conv - 1) * channels * conv_bytes
    inputs = rows * (channels + heads * dk + heads * dv + heads) * act_bytes
    params = channels * conv * act_bytes + heads * 4 + heads * dk * 4 + dv * 4
    out = rows * heads * dv * act_bytes
    flops = rows * (2 * channels * conv + 7 * heads * dk * dv)
    return flops, 2 * state + 2 * conv_state + inputs + params + out
