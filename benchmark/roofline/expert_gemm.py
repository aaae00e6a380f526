"""The work of one layer's experts in the grouped W8A16 kernels
(``moe_gate_up`` then ``moe_down``) for ``rows`` grouped (token, slot) rows
over ``touched`` experts that got at least one (the shared experts run in
the same launches: count their rows and count them as touched).

Operations: ``2 · rows · 3 · D · F`` (gate, up and down, 2 FLOP a
multiply-add).  Bytes, each once: the int8 rows of every touched expert
(``3 · D · F``) and their fp32 scales (``2F + D``); the bf16 activations in
and out of both kernels (x rows and h written by the first, h read and y
written by the second); the int32 index arrays each kernel reads (the
grouped rows' sources, the ``E + 1`` offsets, the tile table of ``rows //
block_m + E`` tiles, two arrays)."""

# kernel names of the grouped GEMMs in the profiler's trace
KERNELS = ("moe_gate_up", "moe_down")


def work(rows: int, touched: float, hidden: int, ffn: int, experts: int,
         block_m: int):
    """→ (FLOPs, bytes)."""
    flops = 2 * rows * 3 * hidden * ffn
    weights = touched * (3 * hidden * ffn + 4 * (2 * ffn + hidden))
    acts = 2 * (rows * hidden + rows * ffn) * 2
    tiles = rows // block_m + experts
    index = 2 * 4 * (rows + experts + 1 + 2 * tiles)
    return flops, weights + acts + index
