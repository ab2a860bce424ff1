"""Read bases built per second: every read base of the window's builds
that finished, over the time from the first build's start to the last
build's end (the frees between builds included), host clock."""


def read(rec):
    builds = rec["builds"]
    done = sum(b["rc"] == 0 for b in builds)
    if not done:
        return None
    return done * rec["bases"] / 1e6 / (builds[-1]["end"] - builds[0]["start"])
