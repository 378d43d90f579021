"""train_mfu: the training step's share of the card's peak, in %: the
step's FLOPs by the configuration's layer equations (`work.step`) over
the mean step wall of the traced run's untraced window, over the bf16
peak (`work.peaks`)."""

from portbench.work import peaks, step


def read(record: dict):
    wall = record.get("step_wall_s")
    if not wall:
        return None
    flops = step.step_flops(record["config"], record["traffic"])
    return 100.0 * flops / wall / peaks.PEAK_FLOPS
