"""Host ms around each traced step into the program, with no synchronise:
the trainer's (``DiffusionTrainer.train_step``) dispatch."""


def read(tr):
    return sum(tr.host_ms) / len(tr.host_ms) if tr.host_ms else None
