"""train_tokens_per_s: training tokens of every step the window ran over
the window's seconds (host clock, each step synchronised)."""


def read(run):
    if run.kind != "train":
        return None
    return run.window["tokens"] / run.window["seconds"]
