"""The detector's stage: CUDA events around each call into
`detect_hand_crop_bbox` made through the pipeline (a span of the
benchmark's), mean per request."""

UNIT = "ms"
LAYER = "detector"
MOVES = "serve_p95_ms"


def read(run):
    spans = run.window.spans.get("detect_ms")
    return sum(spans) / len(spans) if spans else None
