"""Share of the window spent outside the engine's ``generate_images_device``
calls: batching, the writers' PNG encodes joined at each call's end, and
the rest of ``run_step3`` (host spans from the benchmark's engine
subclass)."""


def read(record):
    if record.work.get("stage") != "step3" or record.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.span_seconds("engine") / record.window_s)
