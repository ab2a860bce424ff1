"""Set-up: from the process's start to the end of the warm-up build
(inputs, the port's start, one build of the cell's input), host clock."""


def read(rec):
    return rec["setup"]["setup_s"]
