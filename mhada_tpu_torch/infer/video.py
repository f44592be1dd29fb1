"""Streaming video stylization (mhada_tpu/infer/video.py; reference
infer_video.py).

OpenCV capture -> INTER_AREA resize -> the streaming forward with the
style's features and MHAda keys/values computed once
(``infer.image.precompute_style_kv``; reference infer_video.py:58-61) ->
optional live preview -> per-frame JPEGs and one mp4 (cv2's mp4v) at the
source's FPS (infer_video.py:120-129).  ``--mode Original`` passes frames
through unchanged (infer_video.py:13-14, 93-96).

A reader thread decodes frames into a 4-deep queue while the card
stylises.  Frames cross to the card as uint8 and are cast there; the output
is clamped to [0, 255] and cast to uint8 on the card, which truncates, and
crosses back as uint8.  The readback of one dispatch overlaps the next
dispatch's kernels: right after a dispatch its output starts a
non-blocking copy into pinned host memory and records an event; the next
dispatch is queued; only then does the host wait on the earlier event and
write those frames.  (On one CUDA stream a plain ``.cpu()`` of dispatch i,
issued after dispatch i + 1's kernels, would wait for those too.)

    python -m mhada_tpu_torch.infer.video --video in.mp4 --style s.jpg \\
        [--size 256 512] [--chunk 8] [--dtype bfloat16] [--device cpu]
"""

import argparse
import os
import queue
import threading
import time

import numpy as np
import torch

from ..utils.image_io import cv2_to_tensor, load_image, mkdir
from .image import (DTYPES, add_model_args, make_encode_style_fn,
                    make_stylize_with_kv_fn, models_from_args,
                    precompute_style_kv)


def _style_kv(models, style_hwc, dtype, chunk, session, device):
    """The style's K/V at B = 1 and, for ``chunk`` > 1, tiled to the chunk;
    taken from ``session`` when it holds them, else computed (and stored
    there)."""
    session = {} if session is None else session
    if "kv" not in session:
        style = torch.from_numpy(np.asarray(style_hwc, np.float32))[None]
        session["kv"] = precompute_style_kv(
            models, make_encode_style_fn(models, dtype)(style.to(device)))
    tiled = session.setdefault("kv_chunk", {})
    if chunk > 1 and chunk not in tiled:
        tiled[chunk] = [(k.repeat(chunk, 1, 1), v.repeat(chunk, 1, 1))
                        for k, v in session["kv"]]
    return session["kv"], tiled.get(chunk)


def _to_device(frames: list, device: torch.device) -> torch.Tensor:
    """uint8 HWC frames as one (n, H, W, 3) batch on the device, through
    pinned memory on a card, so the copy does not wait for the stream."""
    batch = torch.from_numpy(np.stack(frames))
    if device.type == "cuda":
        return batch.pin_memory().to(device, non_blocking=True)
    return batch.to(device)


def _start_readback(out: torch.Tensor):
    """A uint8 (n, H, W, 3) batch -> (its host copy, the event that marks it
    done, or None off the card)."""
    if out.device.type != "cuda":
        return out.cpu(), None
    host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def stream_stylize(models: dict, video_path: str, style_hwc: np.ndarray,
                   out_dir: str = "./results/video", size_hw=(256, 512),
                   dtype: torch.dtype = torch.float32,
                   mode: str = "Stylized", show: bool = False,
                   write_mp4: bool = True, max_frames: int = 0,
                   chunk: int = 1, session: dict | None = None,
                   write_jpegs: bool = True) -> int:
    """Stylise every frame of ``video_path`` with ``style_hwc`` (HWC float32
    0-255) on the models' device; returns the number of frames written.

    ``chunk`` > 1 runs that many frames a dispatch, batched against the
    style K/V tiled to match (every op is per frame, so the frames equal
    the B = 1 frames up to the order of float sums); frames left over at
    the end run at B = 1.  Use 1 for live preview latency.

    ``session``: pass the same dict across calls to reuse the style's K/V
    and their tiled copies (a transcode service stylising many clips with
    one style; the style given to later calls is then not read).

    ``write_jpegs=False`` skips the per-frame JPEGs but keeps the readback
    of every frame."""
    import cv2

    device = next(models["vit_c"].parameters()).device
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    mkdir(out_dir, delete_existing_files=True)

    if mode == "Stylized":
        kv, kv_chunk = _style_kv(models, style_hwc, dtype, chunk, session,
                                 device)
        stylize = make_stylize_with_kv_fn(models, dtype)

        @torch.inference_mode()
        def stylize_u8(frames_u8, style_kv):
            return stylize(frames_u8.float(), style_kv).to(torch.uint8)

    frame_q: "queue.Queue" = queue.Queue(maxsize=4)

    def reader():
        n = 0
        while True:
            ret, frame = cap.read()
            if not ret or (max_frames and n >= max_frames):
                break
            frame_q.put(cv2_to_tensor(
                frame, resize=(size_hw[1], size_hw[0]), keep_uint8=True))
            n += 1
        frame_q.put(None)

    threading.Thread(target=reader, daemon=True).start()

    frames = []
    idx = 0
    pending = None   # (first frame index, host batch, event)

    def write(p):
        first, host, done = p
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        for k in range(arr.shape[0]):
            _flush((first + k, arr[k]), frames, out_dir, show, write_mp4,
                   write_jpegs)

    def emit(out):
        """Start ``out``'s readback, then write the dispatch before it,
        which the card finished while this one was queued."""
        nonlocal pending, idx
        started = (idx, *_start_readback(out))
        if pending is not None:
            write(pending)
        pending = started
        idx += out.shape[0]

    buf = []
    while True:
        item = frame_q.get()
        if item is None:
            break
        if mode != "Stylized":
            emit(torch.from_numpy(item)[None])
        elif chunk <= 1:
            emit(stylize_u8(_to_device([item], device), kv))
        else:
            buf.append(item)
            if len(buf) == chunk:
                emit(stylize_u8(_to_device(buf, device), kv_chunk))
                buf = []
    for item in buf:   # tail frames below the chunk size
        emit(stylize_u8(_to_device([item], device), kv))
    if pending is not None:
        write(pending)
    cap.release()

    if write_mp4 and frames:
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(os.path.join(out_dir, "video.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in frames:
            vw.write(f[:, :, ::-1])
        vw.release()
    return idx


def _flush(pending, frames, out_dir, show, keep_frame=True, write_jpeg=True):
    """pending: (frame index, HWC uint8 RGB frame)."""
    import cv2

    i, out = pending
    img = np.asarray(out).astype(np.uint8)
    if keep_frame:
        frames.append(img)
    if write_jpeg:
        cv2.imwrite(os.path.join(out_dir, f"frame_{i:05d}.jpg"),
                    img[:, :, ::-1])
    if show:
        cv2.imshow("mhada_tpu_torch", img[:, :, ::-1])
        if cv2.waitKey(1) & 0xFF == ord("q"):
            raise KeyboardInterrupt


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Checkpoints: reference .pth triples only; the JAX package's "
               "orbax weight directories are not read by this port.")
    ap.add_argument("--video", required=True)
    ap.add_argument("--style", required=True)
    ap.add_argument("--out", default="./results/video")
    ap.add_argument("--size", type=int, nargs=2, default=(256, 512),
                    help="content H W")
    ap.add_argument("--style-size", type=int, nargs=2, default=(256, 256))
    ap.add_argument("--mode", default="Stylized",
                    choices=["Stylized", "Original"])
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=1,
                    help=">1: frames per dispatch (offline throughput mode)")
    add_model_args(ap)
    args = ap.parse_args(argv)

    models = models_from_args(ap, args)
    style = load_image(args.style, tuple(args.style_size))
    t0 = time.perf_counter()
    n = stream_stylize(models, args.video, style, args.out, tuple(args.size),
                       DTYPES[args.dtype], args.mode, args.show,
                       max_frames=args.max_frames, chunk=args.chunk)
    secs = time.perf_counter() - t0
    print(f"processed {n} frames -> {args.out} in {secs:.3f} s "
          f"({1e3 * secs / max(n, 1):.2f} ms/frame wall: style set-up, "
          f"decode, stylization and writes)")


if __name__ == "__main__":
    main()
