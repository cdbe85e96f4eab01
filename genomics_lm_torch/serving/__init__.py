"""Serving: the continuous-batching engine and its HTTP front end."""

from genomics_lm_torch.serving.engine import (
    Request,
    RequestResult,
    ServingEngine,
    init_serving_state,
    serve_steps,
)


def __getattr__(name):
    # lazy: http.server is imported only when the front end is used
    if name == "InferenceServer":
        from genomics_lm_torch.serving.server import InferenceServer

        return InferenceServer
    raise AttributeError(name)


__all__ = [
    "InferenceServer",
    "Request",
    "RequestResult",
    "ServingEngine",
    "init_serving_state",
    "serve_steps",
]
