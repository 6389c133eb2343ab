"""Sampler driver (port of ``ddim_audio_tpu/sampling/driver.py``).

The JAX package runs jitted ``lax.scan`` chunks over precomputed per-step
coefficients; here the per-step loop is eager Python (the carry is the state
x in fp32, the model call is the only heavy per-step device work) and the
chunks of ``_chunk_plan`` only decide where kept states are buffered and
when they leave the device:

- ``sample_last``: carry only, nothing fetched until the end;
- ``sample``: kept states (``select_index``) are written into per-chunk
  device buffers in ``buffer_dtype``; a finished chunk's buffers are copied
  to pinned host memory on a side stream while the next chunk computes, and
  are materialised on the host at the end, or mid-run once the pending
  buffers exceed ``_BUFFER_BUDGET_BYTES`` of device memory (the
  ``--sequence -1`` case).

select_index semantics match the reference: step k (0-based over the
reversed sequence) is kept iff ``k in select_index or k - K in
select_index``; ``None`` keeps every step. CUDA-graph capture of the loop is
later work (ROADMAP.md, queue A).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.tracing import span
from .ddim import ddim_coefficients, ddim_step
from .ddpm import ddpm_coefficients, ddpm_step

# Device bytes of kept-state buffers that may wait for the final drain; read
# at call time, so a run can lower it.
_BUFFER_BUDGET_BYTES = 4 << 30


def selected_steps(num_steps: int, select_index) -> list[int]:
    if select_index is None:
        return list(range(num_steps))
    sel = set(int(s) for s in select_index)
    return [k for k in range(num_steps) if k in sel or k - num_steps in sel]


def _chunk_plan(num_steps, selected, scan_chunk, max_slots):
    """Greedy chunking into homogeneous runs of kept or non-kept steps, each
    <= scan_chunk steps and <= max_slots kept: non-kept stretches allocate
    and write no buffers. Returns [(start, stop, [kept indices])]."""
    sel = set(selected)
    chunks = []
    start = 0
    kept = []
    run_kept = False  # whether the current run consists of kept steps
    for k in range(num_steps):
        is_kept = k in sel
        if k > start and (
            k - start >= scan_chunk
            or len(kept) >= max_slots
            or is_kept != run_kept
        ):
            chunks.append((start, k, kept))
            start, kept = k, []
        if k == start:
            run_kept = is_kept
        if is_kept:
            kept.append(k)
    chunks.append((start, num_steps, kept))
    return [c for c in chunks if c[1] > c[0]]


def _buffer_dtype(buffer_dtype, default: torch.dtype) -> torch.dtype:
    if buffer_dtype is None:
        return default
    if isinstance(buffer_dtype, torch.dtype):
        return buffer_dtype
    return getattr(torch, str(buffer_dtype))


class _HostCopy:
    """A device buffer on its way to the host: on CUDA the copy into pinned
    memory is queued on a side stream behind the work that filled the
    buffer, so it overlaps the next chunk's compute; ``numpy`` waits for it."""

    def __init__(self, buf: torch.Tensor, side):
        self.buf = buf  # alive, and counted against the budget, until drained
        self.event = None
        if buf.device.type != "cuda":
            self.host = buf
            return
        self.host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        side.wait_stream(torch.cuda.current_stream(buf.device))
        with torch.cuda.stream(side):
            self.host.copy_(buf, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(side)
        buf.record_stream(side)

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


class ScanSampler:
    """DDIM ("generalized") or DDPM ("ddpm_noisy") sampling with a denoiser
    ``denoise_fn(params, x, t int64 [B]) -> eps`` in x's layout.

    state_to_saved: optional ``fn(x) -> tensor`` stored in the kept-state
    buffers instead of x itself (the flat sampling state converts back to
    [B, C, T, F]). noise_builder: optional ``fn(generator, x) -> noise`` (the
    flat state draws channel-shaped noise and reshapes it, as the JAX
    package's flat-io adapters). scan_chunk bounds a chunk's steps."""

    def __init__(self, denoise_fn, *, kind: str = "generalized",
                 scan_chunk: int = 100, state_to_saved=None,
                 noise_builder=None):
        if kind not in ("generalized", "ddpm_noisy"):
            raise NotImplementedError(f"sample_type {kind}")
        self.denoise_fn = denoise_fn
        self.kind = kind
        self.scan_chunk = int(scan_chunk)
        self.state_to_saved = state_to_saved
        self.noise_builder = noise_builder

    def _coeff_arrays(self, schedule, seq, eta):
        if self.kind == "generalized":
            c = ddim_coefficients(schedule.alphas_cumprod, seq, eta)
            order = ("t", "at", "at_next", "c1", "c2")
        else:
            c = ddpm_coefficients(schedule.betas, seq)
            order = ("t", "at", "coef_x0", "coef_x", "noise_scale")
        return tuple(c[k] for k in order)

    def _needs_noise(self, eta) -> bool:
        return self.kind == "ddpm_noisy" or eta != 0.0

    def _draw(self, generator, x):
        if self.noise_builder is not None:
            return self.noise_builder(generator, x)
        return torch.randn(x.shape, generator=generator,
                           dtype=x.dtype).to(x.device)

    def _step(self, params, x, coeffs, k: int, noise):
        """One update from step k's coefficients: (x0_pred, x_next), x_next
        in x's dtype (the update arithmetic is fp32)."""
        with span("ddim.sampler.step"):
            t = torch.full((x.shape[0],), int(coeffs[0][k]),
                           dtype=torch.long, device=x.device)
            eps = self.denoise_fn(params, x, t)
            step = ddim_step if self.kind == "generalized" else ddpm_step
            x0, x_next = step(x, eps, *(c[k] for c in coeffs[1:]), noise)
            return x0, x_next.to(x.dtype)

    def sample_last(self, x, seq, schedule, *, eta: float = 0.0,
                    generator: torch.Generator | None = None, params=None):
        """Run the whole reversed subsequence and return only the final x
        (same dtype and device as x)."""
        coeffs = self._coeff_arrays(schedule, seq, eta)
        with_noise = self._needs_noise(eta)
        if with_noise and generator is None:
            generator = torch.Generator().manual_seed(0)
        with span("ddim.sampler.loop"):
            for k in range(len(coeffs[0])):
                noise = self._draw(generator, x) if with_noise else None
                _, x = self._step(params, x, coeffs, k, noise)
        return x

    def sample(self, x, seq, schedule, *, eta: float = 0.0, select_index=None,
               generator: torch.Generator | None = None, noise_override=None,
               params=None, buffer_dtype=None, timings=None):
        """Full path: returns (xs, x0_preds) as lists of host numpy arrays
        (fp32), xs[0] = the input noise; one entry per kept step after it.

        noise_override: optional [K, *x.shape] per-step noises (parity tests
        share them with the JAX package, whose key streams torch cannot
        reproduce). buffer_dtype: dtype of the kept-state buffers on the
        device and in the transfer (float16 halves both); None keeps
        x.dtype. timings: optional dict, filled with ``compute_s`` (wall time
        until every step has run on the device), ``drain_s`` (the rest:
        materialising the kept states on the host) and ``mid_drains``
        (buffer pairs taken to the host mid-run because the pending ones
        exceeded ``_BUFFER_BUDGET_BYTES``)."""
        t_start = time.perf_counter()
        coeffs = self._coeff_arrays(schedule, seq, eta)
        num_steps = len(coeffs[0])
        sel = selected_steps(num_steps, select_index)
        with_noise = self._needs_noise(eta)
        if with_noise and noise_override is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        buf_dtype = _buffer_dtype(buffer_dtype, x.dtype)
        sts = self.state_to_saved or (lambda v: v)
        first = sts(x)
        saved_shape = tuple(first.shape)
        itemsize = torch.empty((), dtype=buf_dtype).element_size()
        pair_bytes = 2 * first.numel() * itemsize
        budget = _BUFFER_BUDGET_BYTES
        max_slots = max(1, int(budget // max(pair_bytes, 1)) - 1)
        chunks = _chunk_plan(num_steps, sel, self.scan_chunk, max_slots)
        on_cuda = x.device.type == "cuda"
        side = torch.cuda.Stream(x.device) if on_cuda else None

        xs = [first.float().cpu().numpy()]
        x0_preds = []
        pending = []  # [(x0 copy, xt copy)] in chunk order, device side alive
        pending_bytes = 0
        mid_drains = 0

        def drain(pair):
            nonlocal pending_bytes
            x0_host, xt_host = pair[0].numpy(), pair[1].numpy()
            for i in range(x0_host.shape[0]):
                x0_preds.append(x0_host[i])
                xs.append(xt_host[i])
            pending_bytes -= x0_host.shape[0] * pair_bytes

        with span("ddim.sampler.loop"):
            for start, stop, kept in chunks:
                slot_of = {k: i for i, k in enumerate(kept)}
                if kept:
                    shape = (len(kept),) + saved_shape
                    x0_buf = torch.empty(shape, dtype=buf_dtype,
                                         device=x.device)
                    xt_buf = torch.empty(shape, dtype=buf_dtype,
                                         device=x.device)
                for k in range(start, stop):
                    noise = None
                    if noise_override is not None:
                        noise = torch.as_tensor(noise_override[k]).to(
                            device=x.device, dtype=x.dtype)
                    elif with_noise:
                        noise = self._draw(generator, x)
                    x0, x = self._step(params, x, coeffs, k, noise)
                    if k in slot_of:
                        x0_buf[slot_of[k]].copy_(sts(x0))
                        xt_buf[slot_of[k]].copy_(sts(x))
                if not kept:
                    continue
                pending.append((_HostCopy(x0_buf, side),
                                _HostCopy(xt_buf, side)))
                pending_bytes += len(kept) * pair_bytes
                # bounds device memory for --sequence -1
                while pending_bytes > budget and len(pending) > 1:
                    drain(pending.pop(0))
                    mid_drains += 1
            if on_cuda:
                torch.cuda.current_stream(x.device).synchronize()
        if timings is not None:
            timings["compute_s"] = time.perf_counter() - t_start
            timings["mid_drains"] = mid_drains
        with span("ddim.sampler.drain"):
            for pair in pending:
                drain(pair)
        if timings is not None:
            timings["drain_s"] = (time.perf_counter() - t_start
                                  - timings["compute_s"])
        return xs, x0_preds
