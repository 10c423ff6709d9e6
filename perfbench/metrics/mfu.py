"""mfu: the model FLOPs of the window's work (perfbench.work, from the
configuration's shapes) over the seconds the program's steps took, as a
share of the card's bfloat16 peak. A closed loop steps all the window;
an open loop's steps leave out the time the queue stood empty."""

from perfbench import work


def read(run):
    if not run.window["step_s"]:
        return None
    return 100.0 * run.window["model_flops"] / run.window["step_s"] \
        / work.MODEL_PEAK
