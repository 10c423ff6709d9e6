"""One driver per kind of traffic (``"kind"`` in a traffic file): the
loop that feeds the program, times the window and keeps what the check
judges."""
