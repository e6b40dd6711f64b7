"""The adapters' merges a call: the program's ``lycoris.merge`` ranges (one
a live layer's W + dW) in the one call recorded with the host's ops."""


def read(tr):
    n = sum(name == "lycoris.merge" for name, _, _ in tr.labels.ranges)
    return float(n) if n else None
