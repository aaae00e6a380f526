"""Faults planted in the program's timed path, for the tests that must see
``correct`` come out false and for the readings that set a training
number's upper limit (``calibrate.py``).  Each is a context manager that
patches the program for its duration.

- ``state_unchanged``: step 5, the optimizer's update leaves the adapters
  and moments as they were; step 3, a decode step's keys and values are not
  written to the cache.
- ``half_batch``: step 5, the loss and gradients of the first half of the
  micro-batch alone (the mean over the rest); step 3, the second half of a
  group's rows decoded as copies of the first half's.
- ``token_altered``: step 3, every sampled token replaced by the next id;
  step 4b, every answer's yes and no probabilities swapped.

Step 4b's ``state_unchanged`` leaves the image prefill's cache as it was
allocated (zeros), and its ``half_batch`` gives the second half of each
call's images the first half's answers.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str, stage: str):
    from ospo_tpu_torch.engine import image_engine
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.train import optim, trainer

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if (name, stage) == ("state_unchanged", "step5"):
        patch(optim.AdamW, "step", lambda self, params, grads: True)
    elif (name, stage) == ("state_unchanged", "step3"):
        real_write = llama._write_kv

        def write(cache, li, start, k, v, positions=None):
            if k.shape[1] > 1:
                real_write(cache, li, start, k, v, positions)

        patch(llama, "_write_kv", write)
    elif (name, stage) == ("half_batch", "step5"):
        real = trainer.SimPOTrainer.loss_and_grads

        def half(self, text_ids, text_mask, chosen, rejected, dropout_seed=None):
            h = len(text_ids) // 2
            return real(self, text_ids[:h], text_mask[:h], chosen[:h], rejected[:h],
                        dropout_seed)

        patch(trainer.SimPOTrainer, "loss_and_grads", half)
    elif (name, stage) == ("half_batch", "step3"):
        real_gen = image_engine.ImageGenEngine._generate_tokens

        def gen(self, tokens, attn_mask, generator):
            out = real_gen(self, tokens, attn_mask, generator).clone()
            h = (out.shape[0] + 1) // 2
            out[h:] = out[:out.shape[0] - h]
            return out

        patch(image_engine.ImageGenEngine, "_generate_tokens", gen)
    elif (name, stage) == ("token_altered", "step3"):
        real_sample = image_engine.sample_categorical

        def altered(logits, temperature, generator):
            return (real_sample(logits, temperature, generator) + 1) % logits.shape[-1]

        patch(image_engine, "sample_categorical", altered)
    elif (name, stage) == ("state_unchanged", "step4b"):
        from ospo_tpu_torch.engine import scoring

        real_prefill = scoring.ScoringEngine._prefill_images

        def prefill(self, *args, **kwargs):
            kv = real_prefill(self, *args, **kwargs)
            for key in ("k", "v", "k_s", "v_s"):
                if key in kv:
                    kv[key].zero_()
            return kv

        patch(scoring.ScoringEngine, "_prefill_images", prefill)
    elif (name, stage) in (("half_batch", "step4b"), ("token_altered", "step4b")):
        from ospo_tpu_torch.engine import scoring

        real_collect = scoring.ScoringEngine._execute_shared_slice

        def collect(self, operands, pre, q_counts):
            out = real_collect(self, operands, pre, q_counts)
            if name == "half_batch":
                h = (len(out) + 1) // 2
                return out[:h] + [out[i % h] if len(out[i % h]["answer_metadata"]) == len(
                    out[i]["answer_metadata"]) else out[i] for i in range(h, len(out))]
            for r in out:
                for a in r["answer_metadata"]:
                    a["p_yes"], a["p_no"] = a["p_no"], a["p_yes"]
            return out

        patch(scoring.ScoringEngine, "_execute_shared_slice", collect)
    else:
        raise ValueError(f"no fault {name!r} for {stage}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


FAULTS = {"step3": ("state_unchanged", "half_batch", "token_altered"),
          "step4b": ("state_unchanged", "half_batch", "token_altered"),
          "step5": ("state_unchanged", "half_batch")}
