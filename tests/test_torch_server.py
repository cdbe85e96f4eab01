"""HTTP round trip against the PyTorch port's ``InferenceServer`` on the CPU.

Same routes and JSON as the JAX server: POST /generate (whole reply or a
chunked stream of JSON event lines), GET /stats and /health, 400 on a bad
body, 404 on an unknown path. Greedy replies equal offline generation.
"""

from __future__ import annotations

import http.client
import json

import numpy as np
import pytest
import torch

from genomics_lm_torch.generation.decode import generate_tokens
from genomics_lm_torch.models.codon_gpt import CodonGPT
from genomics_lm_torch.models.config import CodonGPTConfig
from genomics_lm_torch.serving.engine import ServingEngine
from genomics_lm_torch.serving.server import InferenceServer
from genomics_lm_torch.tokenizers.codon import decode_ids


@pytest.fixture
def served():
    cfg = CodonGPTConfig(vocab_size=68, block_size=96, n_layer=2, n_head=4, n_embd=64,
                         dropout=0.0, attention_impl="flash")
    torch.manual_seed(0)
    model = CodonGPT(cfg).eval()
    server = InferenceServer(
        ServingEngine(model, cfg, slots=2, steps_per_sync=4, device="cpu"), port=0)
    server.start()
    try:
        yield server, model, cfg
    finally:
        server.stop()


def request(server, method, path, body=None):
    conn = http.client.HTTPConnection(*server.address, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_round_trip(served):
    server, model, cfg = served
    prompt = [1] + [int(t) for t in np.random.default_rng(0).integers(4, 68, 7)]
    want = [int(t) for t in generate_tokens(model, cfg, [prompt], 9, None, 0.0,
                                            device="cpu")[0]]

    status, body = request(server, "POST", "/generate",
                           {"prompt": prompt, "max_new_tokens": 9})
    reply = json.loads(body)
    assert status == 200 and reply["tokens"] == want
    assert reply["finish_reason"] == "length" and reply["dna"] == decode_ids(want)

    status, body = request(server, "POST", "/generate",
                           {"prompt": prompt, "max_new_tokens": 9, "stream": True})
    events = [json.loads(line) for line in body.decode().splitlines() if line.strip()]
    assert status == 200 and len(events) >= 2
    assert sum((e["tokens"] for e in events), []) == want
    assert events[-1]["finish_reason"] == "length"

    dna = "ATGAAACCCGGG"
    status, body = request(server, "POST", "/generate",
                           {"dna": dna, "max_new_tokens": 4, "temperature": 1.0})
    reply = json.loads(body)
    assert status == 200 and len(reply["tokens"]) == 4

    status, body = request(server, "GET", "/stats")
    stats = json.loads(body)
    assert status == 200 and stats["completed"] == 3 and stats["slots"] == 2
    assert request(server, "GET", "/health") == (200, b'{"status": "ok"}')
    assert request(server, "GET", "/nope")[0] == 404
    status, body = request(server, "POST", "/generate", {"max_new_tokens": 3})
    assert status == 400 and "prompt" in json.loads(body)["error"]
