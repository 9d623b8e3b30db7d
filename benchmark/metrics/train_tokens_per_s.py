"""train_tokens_per_s: tokens of every training step completed in the
window over the window's seconds (from its start to the last step's loss
on the host). Host clock."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return len(run.steps) * run.counters["tokens_per_step"] / run.window_s
