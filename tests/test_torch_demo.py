"""The port's demo server (``medfusion_tpu_torch/demo/server.py``) on the
CPU, after ``tests/test_demo.py``: a server on port 0 with the smoke preset
(float32, the VAE's zero-init out head perturbed so that images depend on
the latent), its pages, the request-keyed images, ``/one`` micro-batching,
the HTTP errors, and the PNGs read back by the port's decoder."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from medfusion_tpu_torch.data.png import decode_png
from medfusion_tpu_torch.demo import server as S


@pytest.fixture(scope="module")
def demo():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    args = S.parse_args(["--preset", "smoke", "--device", "cpu", "--dtype", "f32",
                         "--port", "0", "--serve-batch", "2"])
    srv, state = S.make_server(args)
    _, pipe = state.pipeline("smoke")
    with torch.no_grad():
        w = pipe.latent_embedder.outc.conv.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(9)) * 0.5)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", state
    srv.shutdown()
    srv.server_close()
    state.close()
    thread.join(timeout=10)
    torch.set_num_threads(n)


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, r.read()


def test_index_and_sample_page(demo):
    url, _ = demo
    status, body = _get(url + "/")
    assert status == 200 and b"medfusion-tpu" in body
    status, body = _get(url + "/sample?preset=smoke&n=2&steps=3&seed=1")
    assert status == 200
    # image tags carry the full request key so /img reproduces this batch
    assert b"/img?preset=smoke" in body and b"seed=1" in body and b"steps=3" in body


def test_img_is_keyed_by_request_not_shared_state(demo):
    url, _ = demo
    _get(url + "/sample?preset=smoke&n=2&steps=3&seed=11")
    _get(url + "/sample?preset=smoke&n=2&steps=3&seed=22")
    img_a0 = _get(url + "/img?preset=smoke&n=2&steps=3&seed=11&i=0")[1]
    img_b0 = _get(url + "/img?preset=smoke&n=2&steps=3&seed=22&i=0")[1]
    assert img_a0 != img_b0, "different seeds must give different images"
    assert img_a0 == _get(url + "/img?preset=smoke&n=2&steps=3&seed=11&i=0")[1]
    img_c = _get(url + "/img?preset=smoke&n=1&steps=3&seed=33&i=0")[1]
    assert decode_png(img_c).shape == (32, 32, 3)
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/img?preset=smoke&n=1&steps=3&seed=33&i=5")
    assert e.value.code == 404


def test_page_fetches_deduplicate_onto_one_sampling(demo, monkeypatch):
    """A page's concurrent /img fetches of a new key wait for one run."""
    url, state = demo
    _, pipe = state.pipeline("smoke")
    calls = []
    real = pipe.sample

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pipe, "sample", counted)
    got = {}

    def fetch(i):
        got[i] = _get(url + f"/img?preset=smoke&n=4&steps=3&seed=77&i={i}")[1]

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert len(got) == 4 and len(calls) == 1
    assert len({got[i] for i in range(4)}) == 4


def test_one_endpoint_micro_batches_concurrent_requests(demo):
    url, state = demo
    before = state.batcher("smoke").batches_run
    results = {}

    def client(seed):
        results[seed] = _get(url + f"/one?preset=smoke&seed={seed}&cond=1")

    threads = [threading.Thread(target=client, args=(s,)) for s in (101, 202)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert set(results) == {101, 202}
    imgs = {s: decode_png(body) for s, (status, body) in results.items() if status == 200}
    assert len(imgs) == 2 and imgs[101].shape == (32, 32, 3)
    assert not np.array_equal(imgs[101], imgs[202])
    assert state.batcher("smoke").batches_run - before <= 2
    # the image depends on (seed, cond) alone: again, in another batch
    assert np.array_equal(decode_png(_get(url + "/one?preset=smoke&seed=101&cond=1")[1]),
                          imgs[101])


def test_one_endpoint_rejects_bad_requests(demo):
    url, _ = demo
    for query in ("preset=typo&seed=1", "preset=smoke&seed=notanint"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(url + f"/one?{query}")
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url + "/nowhere")
    assert e.value.code == 404


def test_server_runs_on_the_card_unless_asked(capsys):
    """Without CUDA the server refuses to start unless --device cpu; on the
    card --no-flash is refused (exit 2)."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_server(S.parse_args(["--preset", "smoke", "--port", "0"]))
    with pytest.raises(SystemExit) as e:
        S.parse_args(["--attention", "spatial", "--no-flash"])
    assert e.value.code == 2 and "--no-flash" in capsys.readouterr().err
