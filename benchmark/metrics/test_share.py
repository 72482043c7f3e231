"""test_share (test rollout, run._run_fused_loop): the share of the window's
wall time spent inside the loop's ``test`` spans (each a greedy rollout of
all of test_nepisode as one wider eager block, between two dispatches), in
percent; the window's two ends on the spans' clock (``ctx["window_ns"]``).
None where the summary has no spans or no test falls in the window."""


def read(ctx):
    spans = ctx["summary"].get("spans")
    if not spans:
        return None
    start, end = ctx["window_ns"]
    inside = sum(max(0, min(s["end_ns"], end) - max(s["start_ns"], start))
                 for s in spans["spans"] if s["name"] == "test")
    if not inside:
        return None
    return 100.0 * inside / (end - start)
