"""Mean host milliseconds of one ``InferenceSession.predict_async`` call in
the window (pad, upload, the forward's launches, the wire's copy), timed
by the benchmark's proxy of the session."""


def read(r):
    calls = r.get("dispatch_host_ms")
    return sum(calls) / len(calls) if calls else None
