"""setup_s: from process start to the first timed pass or session, on
the host clock; loading, generation, packing, building and warm-up."""


def read(r):
    return r.get("setup_s")
