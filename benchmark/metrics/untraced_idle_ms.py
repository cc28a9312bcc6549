"""Device idle under the harness's own span serve.handle_request and in
no span of the port, ms a request: what the port's spans leave unnamed
inside a request. None without a trace."""

SPAN = "serve.handle_request"  # harness.py drive


def read(run):
    if run.trace is None or not run.latencies_s:
        return None
    return run.trace.idle_by_host.get(SPAN, 0.0) / len(run.latencies_s) * 1e3
