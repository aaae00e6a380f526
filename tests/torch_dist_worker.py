"""Worker of ``tests/test_torch_distributed.py``, started once a process by
``scripts/run_multihost_torch.sh <n> torch_dist_worker <mode> [outdir]``
(``tests/`` on ``PYTHONPATH``).  It imports only the port.

- ``merge <outdir>``: joins the world on the CPU, takes its strided share
  of the step-1 fixture with ``shard_for_process``'s defaults, makes a
  step-2-like record of each and, on every rank but 0, of item 0 too (so
  the merge must drop duplicates across ranks), and writes them through
  ``save_json_sharded`` as ``merged.json``; then ``merge_element_sets`` of
  ``{"w<rank>", "shared"}`` as ``elements.json`` from rank 0, and the
  rank's share of item ids as ``shard<rank>.json``.
- ``fail``: rank 1 exits with code 3 at once; the others sleep for ten
  minutes, unless the launcher stops them.
"""

import os
import sys
import time


def main() -> None:
    from ospo_tpu_torch import io as io_lib
    from ospo_tpu_torch.platform import maybe_init_distributed

    mode = sys.argv[1]
    maybe_init_distributed("cpu")
    rank, n = io_lib.process_index(), io_lib.process_count()
    if mode == "fail":
        if rank == 1:
            sys.exit(3)
        time.sleep(600)
        return

    outdir = sys.argv[2]
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures", "examples")
    items = io_lib.read_json(os.path.join(fixtures, "step1",
                                          "base_prompt.json"))
    local = io_lib.shard_for_process(items)
    io_lib.save_json(outdir, f"shard{rank}", [r["item_id"] for r in local])
    recs = [{**r, "negative_prompt": [f"neg-{r['item_id']}"]} for r in local]
    if rank:
        recs.append({**items[0],
                     "negative_prompt": [f"neg-{items[0]['item_id']}"]})
    path = io_lib.save_json_sharded(outdir, "merged", recs)
    if (path is None) != (rank != 0):
        sys.exit(f"rank {rank}: save_json_sharded returned {path!r}")
    elements = io_lib.merge_element_sets({f"w{rank}", "shared"})
    if rank == 0:
        io_lib.save_json(outdir, "elements", elements)
    print(f"# worker {rank}/{n} done", flush=True)


if __name__ == "__main__":
    main()
