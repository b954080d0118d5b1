"""``setup_s``: process start to the opening of the window (weights,
``pack_tree``, libraries loaded, warm-up steps), on the host's clock."""


def read(run) -> float:
    return run.setup_s
