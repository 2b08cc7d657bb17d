"""Explanation serving over HTTP (port of `autognothi_tpu/pipeline/serve.py`).

    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --port 8321 --batch-size 8

    POST /explain {"texts": ["...", ...]}   # text models: tokenized with
                                            # <exp>/tokenizer/vocab.txt into
                                            # int64 rows <T>
    POST /explain {"images": [[[...]]]}     # <B, C, H, W> float rows
    POST /explain {"images_u8": [[[...]]]}  # uint8 rows, dequantized on the
                                            # device (x * scale + offset)
    GET  /healthz
    GET  /statz                             # slab occupancy, latency and
                                            # the span totals (`spans`)

    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --artifact final.agx        # an `export_final` artifact instead of
                                    # the checkpoints

Requests coalesce into fixed-size slabs through `MicroBatcher` (a port of
the JAX package's framework-free batcher).  Its dispatcher thread
launches every slab on PyTorch's current stream; its completer thread
copies the results to the host, which waits for that stream.

In a world of N ranks (`parallel/distributed.py`) rank 0 owns the HTTP
server and the batcher, and the slab batch is rounded up to a multiple of
N.  For each slab rank 0 broadcasts a small header and then the padded
slab; every rank runs its N-th of the rows (`parallel.mesh.
sharded_serving_fn`, or the ranks of an `--artifact` exported with
`--data-parallel N`) and the outputs are all-gathered.  The other ranks
run `follow` and never bind a port; SIGTERM on rank 0 drains the slabs in
flight and then broadcasts a stop, and every rank exits 0.  KernelSHAP's
host final (`fw_final_host`) and a one-device artifact run on rank 0
alone.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..parallel.distributed import rank, world_size
from ..parallel.mesh import axis_size, setup_data_parallel, sharded_serving_fn
from ..utils import tracing
from ..utils.devices import resolve_device
from .batching import MicroBatcher
from .env import ExpEnv
from .resources import get_recipe, load_epoch_model


class ExplainService:
    def __init__(self, env: ExpEnv, batch_size: int = 8,
                 window_s: float = 0.0,
                 u8_dequant: Tuple[float, float] = (1.0 / 255.0, 0.0),
                 artifact=None, device: str = "cuda"):
        self.env = env
        self.device = resolve_device(device)
        self.recipe, self.m_config = get_recipe(env.config)
        self.misc = (None if self.recipe.load_misc is None
                     else self.recipe.load_misc(env.model_path,
                                                self.m_config))
        self.gen_input = self.recipe.gen_input(self.m_config, self.misc)
        self._row_shape = tuple(
            self.recipe.gen_null(self.m_config, self.misc).shape[1:])
        self.artifact = None
        # every rank receives each slab and runs its share of it
        self.followed = False
        if artifact is None:
            _, self.model = load_epoch_model(env, self.recipe, "final",
                                             self.device)
            self._fw = lambda model, xs: self.recipe.fw_final(
                self.m_config, model, xs)
            mesh, place_params, _ = setup_data_parallel(self.device)
            if mesh is not None and not self.recipe.fw_final_host:
                n = axis_size(mesh, "data")
                batch_size = -(-batch_size // n) * n
                env.log(f"[[[ serving sharded over {n} devices "
                        f"(batch {batch_size}) ]]]")
                self.model = place_params(self.model)
                self._fw = sharded_serving_fn(self._fw, mesh)
                self.followed = True
        else:
            batch_size = self._load_artifact(artifact, batch_size)
        self.batch_size = batch_size
        self.u8_scale, self.u8_offset = (float(v) for v in u8_dequant)
        self._batcher = None
        if rank() == 0:
            self._batcher = MicroBatcher(
                self._run_slab, batch_size, window_s=window_s, depth=2,
                finalize=lambda outs: tuple(o.float().cpu().numpy()
                                            for o in outs))

    def _load_artifact(self, artifact, batch_size: int) -> int:
        """Serve an `export_final` artifact: the program and its weights are
        the deployment unit, no checkpoint is read.  A fixed-batch artifact
        sets the slab size, a symbolic one keeps `batch_size`; -> the slab
        size.  An artifact of another experiment's rows fails here, at
        startup, not in the dispatcher at the first request."""
        from .export import load_exported

        call = load_exported(artifact, device=str(self.device))
        null = np.asarray(self.recipe.gen_null(self.m_config, self.misc))
        if tuple(call.in_shape[1:]) != self._row_shape or \
                call.in_dtype != null.dtype:
            raise RuntimeError(
                f"artifact {artifact} expects rows {tuple(call.in_shape[1:])} "
                f"{call.in_dtype}, but this experiment's model takes "
                f"{null.shape[1:]} {null.dtype} — it was exported from a "
                "different experiment/config")
        if call.in_shape[0] is not None:
            batch_size = call.in_shape[0]
        self.artifact, self.model = call, None
        self.followed = call.nr_devices > 1
        self.env.log(f"[[[ serving artifact {artifact}: input "
                     f"{call.in_shape} {call.in_dtype}, platforms "
                     f"{call.platforms}, kernels {call.meta['kernels']}, "
                     f"quant {call.meta['quant']} (batch {batch_size}) ]]]")
        return batch_size

    def _run_slab(self, slab: np.ndarray):
        """One fixed-size slab through fw_final (or the artifact's program);
        returns device tensors (the completer thread copies them to the
        host).  On rank 0 of a followed world the slab goes to every rank
        first."""
        with tracing.span("serve.h2d"):
            xs = torch.as_tensor(np.ascontiguousarray(slab)).to(self.device)
            if self.followed:
                _send(_SLAB, xs)
            xs = self._dequant(xs)
        with tracing.span("serve.forward"):
            return self._forward(xs)

    def _dequant(self, xs: torch.Tensor) -> torch.Tensor:
        """uint8 rows -> float rows on the device (x * scale + offset)."""
        if xs.dtype != torch.uint8:
            return xs
        with torch.inference_mode():
            return xs.float() * self.u8_scale + self.u8_offset

    def _forward(self, xs: torch.Tensor):
        with torch.inference_mode():
            if self.artifact is not None:
                return self.artifact(xs)
            return self._fw(self.model, xs)

    def follow(self) -> int:
        """A rank past 0: run each slab rank 0 broadcasts until its stop
        -> the number of slabs run."""
        slabs = 0
        while True:
            xs = _receive(self.device)
            if xs is None:
                return slabs
            self._forward(self._dequant(xs))
            slabs += 1

    def close(self) -> None:
        """Drain the slabs in flight; then rank 0 of a followed world tells
        the other ranks to stop."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
            if world_size() > 1:
                _send(_STOP, None, self.device)

    def warmup(self) -> None:
        """Run the null slab (and, for float rows, its u8 form) to the end,
        so kernels are built and loaded before the server reports ready."""
        null = np.repeat(self.recipe.gen_null(self.m_config, self.misc),
                         self.batch_size, axis=0)
        slabs = [null]
        if np.issubdtype(null.dtype, np.floating):
            slabs.append(np.clip(null * 255.0, 0, 255).astype(np.uint8))
        for slab in slabs:
            outs = self._run_slab(slab)
            for o in outs:
                o.cpu()

    def explain(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        with tracing.span("serve.payload"):
            xs = self._rows(payload)
        if xs is None or xs.shape[0] == 0:
            return {"logits": [], "attributions": []}
        logits, attr = self._batcher.submit(xs)
        with tracing.span("serve.respond"):
            return {"logits": logits.tolist(), "attributions": attr.tolist()}

    def _rows(self, payload: Dict[str, Any]):
        """A request's payload -> its rows (None for an empty text list)."""
        if "texts" in payload:
            if isinstance(payload["texts"], str):
                raise ValueError("'texts' must be a list of strings")
            raw = list(payload["texts"])
            if not raw:
                return None
            return self.gen_input(raw, [0] * len(raw))[0]
        if "images" in payload:
            try:
                xs = np.asarray(payload["images"], dtype=np.float32)
            except (ValueError, TypeError) as err:
                raise ValueError(
                    "'images' must be a rectangular numeric array of shape "
                    f"<B, C, H, W> ({err})") from err
        elif "images_u8" in payload:
            try:
                xs = np.asarray(payload["images_u8"], dtype=np.uint8)
            except (ValueError, TypeError) as err:
                raise ValueError(
                    "'images_u8' must be rectangular uint8 <B, C, H, W> "
                    f"({err})") from err
        else:
            raise ValueError("payload needs 'texts', 'images' or 'images_u8'")
        if xs.shape[0] and tuple(xs.shape[1:]) != self._row_shape:
            raise ValueError(
                f"image rows must be shaped {self._row_shape} "
                f"(<C, H, W> for this model); got rows {tuple(xs.shape[1:])} "
                f"from payload shape {tuple(xs.shape)}")
        return xs


# the header rank 0 broadcasts before each slab: (op, dtype, ndim, shape)
_STOP, _SLAB = 0, 1
_HEADER = 8
_DTYPES = (torch.float32, torch.uint8, torch.int64)  # images, u8, texts


def _send(op: int, xs: torch.Tensor = None, device=None) -> None:
    import torch.distributed as dist

    header = torch.zeros(_HEADER, dtype=torch.int64,
                         device=xs.device if xs is not None else device)
    header[0] = op
    if xs is not None:
        header[1], header[2] = _DTYPES.index(xs.dtype), xs.dim()
        header[3:3 + xs.dim()] = torch.tensor(xs.shape)
    dist.broadcast(header, src=0)
    if xs is not None:
        dist.broadcast(xs.contiguous(), src=0)


def _receive(device: torch.device):
    """The next slab rank 0 broadcasts, or None at its stop."""
    import torch.distributed as dist

    header = torch.zeros(_HEADER, dtype=torch.int64, device=device)
    dist.broadcast(header, src=0)
    op, code, ndim, *shape = header.tolist()
    if op == _STOP:
        return None
    xs = torch.empty(shape[:ndim], dtype=_DTYPES[code], device=device)
    dist.broadcast(xs, src=0)
    return xs


def make_server(service: ExplainService, host: str = "127.0.0.1",
                port: int = 8321) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: Dict[str, Any]) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/statz":
                self._reply(200, {**service._batcher.stats(),
                                  "spans": tracing.totals()})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/explain":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except Exception as exc:  # noqa: BLE001 — malformed request
                self._reply(400, {"error": str(exc)})
                return
            try:
                self._reply(200, service.explain(payload))
            except ValueError as exc:
                self._reply(400, {"error": str(exc)})  # client payload
            except Exception as exc:  # noqa: BLE001 — server/device fault
                self._reply(500, {"error": str(exc)})

    return ThreadingHTTPServer((host, port), Handler)


def serve(env: ExpEnv, host: str, port: int, batch_size: int,
          window_s: float = 0.0,
          u8_dequant: Tuple[float, float] = (1.0 / 255.0, 0.0),
          artifact=None, device: str = "cuda") -> None:
    import signal

    service = ExplainService(env, batch_size, window_s=window_s,
                             u8_dequant=u8_dequant, artifact=artifact,
                             device=device)
    if rank() > 0:
        # no port: this rank runs its share of rank 0's slabs
        slabs = service.follow()
        env.log(f"[[[ serve: rank {rank()} ran {slabs} slabs, stopped ]]]")
        return
    env.log("[[[ warming up the explain step... ]]]")
    service.warmup()
    server = make_server(service, host, port)
    # join in-flight handler threads on close (daemon threads are skipped)
    server.daemon_threads = False
    draining = {"requested": False}

    def _drain(signum, frame):
        if draining["requested"]:
            # second TERM: a wedged drain must stay killable
            restored = (prev_term if callable(prev_term) or prev_term
                        in (signal.SIG_DFL, signal.SIG_IGN)
                        else signal.SIG_DFL)
            signal.signal(signal.SIGTERM, restored)
            signal.raise_signal(signal.SIGTERM)
            return
        draining["requested"] = True
        env.log("[[[ SIGTERM — draining in-flight requests ]]]")
        # shutdown() waits for serve_forever to return: off the main thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        prev_term = signal.signal(signal.SIGTERM, _drain)
    except ValueError:  # not the main thread
        prev_term = None
    env.log(f"[[[ serving explanations on http://{host}:{port} "
            f"({service.device}) ]]]")
    try:
        server.serve_forever()
    finally:
        # in-flight handlers may still be inside batcher.submit: join them
        # before the batcher goes away
        server.server_close()
        service.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    env.log("[[[ serve: drained and closed ]]]")


def serve_in_thread(env: ExpEnv, host: str = "127.0.0.1", port: int = 0,
                    batch_size: int = 4, window_s: float = 0.0,
                    artifact=None, device: str = "cuda"):
    """-> (server, service, thread); port 0 picks a free one."""
    service = ExplainService(env, batch_size, window_s=window_s,
                             artifact=artifact, device=device)
    service.warmup()
    server = make_server(service, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, service, thread
