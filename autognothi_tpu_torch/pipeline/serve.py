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

On a card a slab's device work (the u8 dequant and `fw_final`) is one
CUDA graph per input key (the host slab's shape and dtype): the first slab
of a key runs eagerly, which fills the one-time caches (kernel loading,
shared-memory attributes, weight codes), the second is captured, and every
later one is replayed, one launch in place of several hundred.  Around a
replay every copy is queued on the stream: the slab goes through a pinned
staging buffer into the graph's static input, and the graph, which ends
by writing every output into one flat float32 buffer, is followed by that
buffer's copy into a fresh pinned host buffer, which the completer reads
once the slab's event has passed.  The dispatcher then waits until the
card reaches the slab, and packs the next one while the card runs it, so
the card always has the next slab queued.  `warmup`
runs each of its slabs twice, so the served keys replay from the first
request.  A key whose capture raises runs eagerly for the rest of the
service's life.  A followed world, an artifact and a host final
(`replays_slabs`) always run eagerly.  `/statz` counts `graph_captures`,
`graph_replays`, `eager_slabs` and `graph_fallbacks`.  The kernel ops'
`LaunchCounter`s count the calls that went to a kernel: an eager or a
captured slab's, and nothing for a replay.

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
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from ..parallel.distributed import rank, world_size
from ..parallel.mesh import axis_size, setup_data_parallel, sharded_serving_fn
from ..utils import tracing
from ..utils.devices import resolve_device
from .batching import MicroBatcher
from .env import ExpEnv
from .resources import get_recipe, load_epoch_model

# a slab's input key: the host slab's shape and dtype
SlabKey = Tuple[Tuple[int, ...], str]


def replays_slabs(device: torch.device, followed: bool, artifact,
                  host_final: bool) -> bool:
    """Whether a service replays its slabs as CUDA graphs: on a card, for a
    live final that runs on this process's device alone.  A followed world
    keeps its per-slab broadcast and collectives eager, an artifact runs
    its own program, and a host final (KernelSHAP's WLS) leaves the
    device."""
    return (device.type == "cuda" and not followed and artifact is None
            and not host_final)


def _recorded(cuda: bool) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream (None off a card)."""
    if not cuda:
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class SlabOutputs:
    """A replayed slab's outputs: one flat float32 host tensor, which holds
    each output in turn once `done` has passed, and the outputs' shapes."""

    __slots__ = ("flat", "shapes", "done")

    def __init__(self, flat: torch.Tensor,
                 shapes: Tuple[Tuple[int, ...], ...],
                 done: Optional[torch.cuda.Event] = None):
        self.flat, self.shapes, self.done = flat, shapes, done

    def fetch(self) -> Tuple[np.ndarray, ...]:
        if self.done is not None:
            self.done.synchronize()
        host = self.flat.numpy()
        outs, at = [], 0
        for shape in self.shapes:
            n = math.prod(shape)
            outs.append(host[at:at + n].reshape(shape))
            at += n
        return tuple(outs)


def fetch(outs) -> Tuple[np.ndarray, ...]:
    """A slab's outputs on the host as float32 arrays (the completer's
    work): a replayed slab's from its host buffer, an eager slab's copied
    one by one."""
    if isinstance(outs, SlabOutputs):
        return outs.fetch()
    return tuple(o.float().cpu().numpy() for o in outs)


class SlabGraph:
    """One input key's captured slab: the static device input, the graph of
    its device work, which ends by writing every output into one static
    flat buffer, the outputs' shapes, and the pinned staging buffer each
    slab passes through on its way to the static input."""

    def __init__(self, graph, static_in: torch.Tensor, flat: torch.Tensor,
                 shapes: Tuple[Tuple[int, ...], ...]):
        self.graph, self.static_in, self.flat = graph, static_in, flat
        self.shapes = shapes
        self.cuda = flat.is_cuda
        self.staging = torch.empty(static_in.shape, dtype=static_in.dtype,
                                   pin_memory=self.cuda)
        self._copied: Optional[torch.cuda.Event] = None

    def load(self, slab: np.ndarray) -> None:
        """Queue the slab's copy, through the staging buffer, into the
        static input."""
        self._reached()
        self.staging.numpy()[...] = slab
        self.static_in.copy_(self.staging, non_blocking=True)
        self._copied = _recorded(self.cuda)

    def replay(self) -> SlabOutputs:
        """Queue the graph on the loaded slab and the copy of its outputs
        into a fresh host buffer (the next replay overwrites the static
        ones, and at the batcher's depth 2 the completer may fetch slab n
        after slab n + 1 was replayed); then wait until the card has
        reached the slab.  So the card has the slab queued behind the one
        it runs, and the dispatcher packs the next slab from the queue as
        it stands when this one starts, not a slab earlier."""
        self.graph.replay()
        host = torch.empty(self.flat.shape, pin_memory=self.cuda)
        host.copy_(self.flat, non_blocking=True)
        outs = SlabOutputs(host, self.shapes, _recorded(self.cuda))
        self._reached()
        return outs

    def _reached(self) -> None:
        """Wait until the last loaded slab's copy has run: the card has
        reached that slab, and the staging buffer is free again."""
        if self._copied is not None:
            self._copied.synchronize()


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
        self.replays = replays_slabs(self.device, self.followed,
                                     self.artifact, self.recipe.fw_final_host)
        # written by the one thread that runs slabs (the dispatcher, or
        # warmup's caller before it)
        self._graphs: Dict[SlabKey, SlabGraph] = {}
        self._seen: Set[SlabKey] = set()       # keys run eagerly once
        self._eager_keys: Set[SlabKey] = set()  # keys whose capture failed
        self._capture_stream = (torch.cuda.Stream(self.device)
                                if self.replays else None)
        self.slab_counts = {"graph_captures": 0, "graph_replays": 0,
                            "eager_slabs": 0, "graph_fallbacks": 0}
        self._batcher = None
        if rank() == 0:
            self._batcher = MicroBatcher(
                self._run_slab, batch_size, window_s=window_s, depth=2,
                finalize=fetch)

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
        returns device tensors, or a replayed slab's `SlabOutputs` (the
        completer thread copies them to the host, `fetch`).  A captured key
        replays its graph; on rank 0 of a followed world the slab goes to
        every rank first."""
        slab = np.ascontiguousarray(slab)
        key = (slab.shape, slab.dtype.str)
        graph = self._graphs.get(key)
        if graph is not None:
            with tracing.span("serve.h2d"):
                graph.load(slab)
            with tracing.span("serve.forward"):
                return self._replay(graph)
        with tracing.span("serve.h2d"):
            xs = torch.as_tensor(slab).to(self.device)
            if self.followed:
                _send(_SLAB, xs)
        with tracing.span("serve.forward"):
            if self.replays and key in self._seen and \
                    key not in self._eager_keys:
                try:
                    graph = self._capture(xs)
                except Exception as exc:  # noqa: BLE001 — the key runs eager
                    self._eager_keys.add(key)
                    self.slab_counts["graph_fallbacks"] += 1
                    self.env.log(f"[[[ serve: slabs {key} stay eager, their "
                                 f"capture failed: {exc!r} ]]]")
                else:
                    self._graphs[key] = graph
                    self.slab_counts["graph_captures"] += 1
                    return self._replay(graph)
            self._seen.add(key)
            self.slab_counts["eager_slabs"] += 1
            return self._forward(self._dequant(xs))

    def _replay(self, graph: SlabGraph) -> SlabOutputs:
        self.slab_counts["graph_replays"] += 1
        return graph.replay()

    def _capture(self, xs: torch.Tensor) -> SlabGraph:
        """The device work of a slab whose input is `xs`, captured; `xs`
        becomes the graph's static input.  The key ran eagerly before, so
        no one-time work is captured."""
        graph = torch.cuda.CUDAGraph()
        # the outer context restores the current stream should the capture
        # fail in `capture_end`; thread_local: the completer may fetch
        # while this thread captures
        with torch.cuda.stream(self._capture_stream), torch.cuda.graph(
                graph, stream=self._capture_stream,
                capture_error_mode="thread_local"), torch.inference_mode():
            outs = tuple(self._forward(self._dequant(xs)))
            flat = torch.cat([o.float().reshape(-1) for o in outs])
        return SlabGraph(graph, xs, flat,
                         tuple(tuple(o.shape) for o in outs))

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
        self._graphs.clear()  # their memory pools

    def warmup(self) -> None:
        """Run the null slab (and, for float rows, its u8 form) to the end,
        so kernels are built and loaded before the server reports ready;
        where slabs replay, twice each, so that their keys are captured."""
        null = np.repeat(self.recipe.gen_null(self.m_config, self.misc),
                         self.batch_size, axis=0)
        slabs = [null]
        if np.issubdtype(null.dtype, np.floating):
            slabs.append(np.clip(null * 255.0, 0, 255).astype(np.uint8))
        for slab in slabs:
            for _ in range(2 if self.replays else 1):
                fetch(self._run_slab(slab))

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
                                  **service.slab_counts,
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
