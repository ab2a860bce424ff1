"""The port's start: from its import to the return of cli._warm (CUDA
context, kernel and ingest libraries, a small build), host clock."""


def read(rec):
    return rec["setup"]["port_start_s"]
