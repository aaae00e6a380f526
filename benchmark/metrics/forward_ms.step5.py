"""Device milliseconds an update in ``train.forward``: the program's CUDA
events around the embeddings, the LoRA trunk with remat, the generation head
and the SimPO loss, summed over the window and divided by its updates
(``train.update`` spans)."""

from harness.program_spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "step5", "train.forward", "device_s", "train.update")
