"""Host milliseconds of one ``ensemble_locate`` call (the Locator's
labelling of every member's map and the clustering of their atoms), ended
by a synchronise: the mean over the untraced stretch's calls."""


def read(ctx):
    spans = ctx.spans.get("ensemble_locate")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
