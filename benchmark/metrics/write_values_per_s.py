"""write_values_per_s: the numbers the window's jobs formatted into model
files (the ``write.values`` counter) over their seconds in ``write`` spans.
A program that does not count them gives nothing to read."""

from benchlib.spans import total


def read(run):
    values = secs = 0.0
    for job in run.jobs:
        counts = job["events"].get("counts")
        spans = job["events"].get("span")
        if not counts or not spans or "write.values" not in counts[-1]["counts"]:
            return None
        values += counts[-1]["counts"]["write.values"]
        secs += total("write")(spans)
    return values / secs if secs > 0 else None
