"""build_s (set-up: run.build_training, the kernel libraries): seconds in
the program's set-up spans of the env, controller, runner and learner
(build.*) and of each kernel library's first load (library.*: the first
carries the build of every CUDA source where none is built), each span
counted once where one lies inside another. None where the summary has no
spans."""

PREFIXES = ("build.", "library.")


def read(ctx):
    spans = ctx["summary"].get("spans")
    if not spans:
        return None
    chosen = {s["id"]: s for s in spans["spans"] if s["name"].startswith(PREFIXES)}
    parents = {s["id"]: s["parent"] for s in spans["spans"]}

    def nested(s):
        p = s["parent"]
        while p is not None:
            if p in chosen:
                return True
            p = parents.get(p)
        return False

    return sum(s["end_ns"] - s["start_ns"] for s in chosen.values() if not nested(s)) / 1e9
