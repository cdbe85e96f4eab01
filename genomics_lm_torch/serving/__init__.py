"""Serving: the continuous-batching engine, speculative decoding, and the
HTTP front end."""

from genomics_lm_torch.serving.engine import (
    Request,
    RequestResult,
    ServingEngine,
    init_serving_state,
    serve_steps,
)
from genomics_lm_torch.serving.speculative import (
    fit_bigram_table,
    generate_tokens_speculative,
    serve_steps_speculative,
    speculative_generate,
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
    "fit_bigram_table",
    "generate_tokens_speculative",
    "init_serving_state",
    "serve_steps",
    "serve_steps_speculative",
    "speculative_generate",
]
