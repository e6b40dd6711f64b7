"""Host ms around each traced call into the program, with no synchronise:
the serving loop's and the wrapper interceptor's dispatch."""


def read(tr):
    return sum(tr.host_ms) / len(tr.host_ms) if tr.host_ms else None
