"""Share of the traced stretch of generation calls with nothing on the
card while the host was inside ``batch_subgraphs`` (``gcc.generate.batch``,
the innermost span open), in %; None where nothing ran on the card."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "embed" or not tr or tr["busy_s"] <= 0:
        return None
    idle = tr.get("idle_by_span", {}).get("gcc.generate.batch")
    return None if idle is None else 100.0 * idle / tr["window_s"]
