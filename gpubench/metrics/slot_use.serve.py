"""Share of the engine's slot-frames that carried a request over the
window: ContinuousStats frames_emitted / (blocks x K x slots), in %."""


def read(layer: dict):
    c = layer.get("engine_counts")
    if not c or not c["steps"]:
        return None
    return (100.0 * c["frames_emitted"]
            / (c["steps"] * c["frames_per_step"] * c["n_slots"]))
