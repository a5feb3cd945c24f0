"""Set-up: from process start to the window's opening (imports, the
kernel library's build or load, weights, prune, pack, traffic, warm-up
or ramp)."""


def read(rec):
    return rec["setup_s"]
