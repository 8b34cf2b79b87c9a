"""``train_inst_steps_per_s``: every instance-step of every call in the
window (one Adam step of one (setting, fold) instance) over the window's
time, from the first enqueue to the final synchronise, by the host's
clock."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return ctx["inst_steps"] / ctx["window_s"]
