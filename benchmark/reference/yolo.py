"""YOLOv8 (Ultralytics' ``yolov8.yaml``: CSPDarknet backbone, PAN neck,
decoupled DFL head) in float32 over a Flax-layout ``.npz`` checkpoint, read
here: BatchNorm folded into each convolution, NCHW, no kernels of the port.

``Detector.forward`` runs the float32 network, or, given a calibration from
:meth:`Detector.calibrate`, its post-training fake-quantized form at ``bits``
(8: int8, 4: int4): per-output-channel symmetric weights folded with their
input's per-channel scales, per-tensor symmetric activation scales from the
calibration's abs-max, quantized values carried between layers (concat,
max-pool and upsample on them), residual adds dequantized, summed and
requantized, head logits left unquantized.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STRIDES = (8, 16, 32)
PAD_VALUE = 114 / 255.0


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def load_checkpoint(path: str) -> dict[str, np.ndarray]:
    """The ``params/...`` and ``batch_stats/...`` arrays of the file (its
    pickled ``__meta__`` entry is never read)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: np.asarray(z[k], dtype=np.float32) for k in z.files if k != "__meta__"}


def fuse(arrays: dict[str, np.ndarray]) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Every convolution as (OIHW weight, bias) in float32, BatchNorm folded:
    ``W·γ/√(σ²+ε)``, ``β − μ·γ/√(σ²+ε)``."""
    out = {}
    for key, kernel in arrays.items():
        if not (key.startswith("params/") and key.endswith("/kernel")):
            continue
        path = key[len("params/"):-len("/kernel")]
        w = kernel.transpose(3, 2, 0, 1)
        if path.endswith("/conv"):
            node = path[: -len("/conv")]
            if f"params/{node}/bn/scale" in arrays:
                g, b = arrays[f"params/{node}/bn/scale"], arrays[f"params/{node}/bn/bias"]
                mu, var = arrays[f"batch_stats/{node}/bn/mean"], arrays[f"batch_stats/{node}/bn/var"]
                f = g / np.sqrt(var + BN_EPS)
                out[node.replace("/", ".")] = (w * f[:, None, None, None], b - mu * f)
            else:
                out[node.replace("/", ".")] = (w, arrays[f"params/{node}/conv/bias"])
        else:  # the head's last 1x1 convolutions: no BatchNorm
            out[path.replace("/", ".")] = (w, arrays[f"params/{path}/bias"])
    return {k: (np.ascontiguousarray(w, np.float32), np.asarray(b, np.float32)) for k, (w, b) in out.items()}


def letterbox(views: torch.Tensor, content_hw: tuple[int, int], imgsz: int) -> tuple[torch.Tensor, tuple]:
    """(N, H, W) float views in [0, 255] whose content is the top-left
    ``content_hw`` -> (N, 3, imgsz, imgsz) float32 in [0, 1]: a bilinear
    resize (half-pixel centres) keeping the aspect ratio, centred on a
    114-grey canvas; and the (scale, pad_top, pad_left) geometry."""
    sh, sw = content_hw
    scale = min(imgsz / sh, imgsz / sw)
    nh, nw = round(sh * scale), round(sw * scale)
    top, left = (imgsz - nh) // 2, (imgsz - nw) // 2
    x = views[:, None, :sh, :sw].to(torch.float32) / 255.0
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    x = F.pad(x, (left, imgsz - nw - left, top, imgsz - nh - top), value=PAD_VALUE)
    return x.expand(-1, 3, -1, -1), (scale, top, left)


class _Q:
    """A fake-quantized tensor: integer values (float32) and the per-channel
    scales they stand for."""

    def __init__(self, q: torch.Tensor, scales: np.ndarray):
        self.q, self.scales = q, np.asarray(scales, np.float64)

    def dequant(self) -> torch.Tensor:
        if not (self.scales == self.scales[0]).all():
            raise ValueError("an add expects one scale across its channels")
        return self.q * float(self.scales[0])


class Detector:
    """The detector over one checkpoint, on ``device``."""

    def __init__(self, path: str, device, reg_max: int = 16):
        self.dev = torch.device(device)
        self.reg_max = reg_max
        arrays = load_checkpoint(path)
        self.w = {k: (torch.from_numpy(w).to(self.dev), torch.from_numpy(b).to(self.dev)) for k, (w, b) in fuse(arrays).items()}
        self.depth = {}  # C2f block -> bottlenecks
        for key in arrays:
            parts = key.split("/")
            if len(parts) > 3 and parts[2].startswith("m_"):
                self.depth[parts[1]] = max(self.depth.get(parts[1], 0), int(parts[2][2:]) + 1)
        self.absmax: dict[str, float] | None = None
        self.bits = 0
        self._wq: dict = {}

    # -- the quantized form ----------------------------------------------------

    def calibrate(self, x: torch.Tensor, bits: int) -> None:
        """Abs-max of every quantization point over the float32 forward of the
        letterboxed calibration batch ``x``; later forwards run quantized."""
        self.absmax, self.bits, self._wq = {}, 0, {}
        self._record = True
        with torch.no_grad():
            self._graph(x)
        self._record = False
        self.bits = bits

    @property
    def _qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def _scale(self, name: str) -> float:
        return max(self.absmax[name], 1e-6) / self._qmax

    def _quant(self, y: torch.Tensor, scale: float) -> torch.Tensor:
        return torch.round(y / scale).clamp(-self._qmax, self._qmax)

    def _note(self, name: str, y: torch.Tensor) -> None:
        if getattr(self, "_record", False):
            self.absmax[name] = max(self.absmax.get(name, 0.0), float(y.abs().max()))

    def _qweights(self, name: str, s_in: np.ndarray):
        if name not in self._wq:
            w, b = self.w[name]
            w = w.double() * torch.from_numpy(s_in).to(self.dev)[None, :, None, None]
            sw = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / self._qmax
            wq = torch.round(w / sw[:, None, None, None]).clamp(-self._qmax, self._qmax)
            self._wq[name] = (wq.float(), sw.float(), b)
        return self._wq[name]

    # -- the graph -------------------------------------------------------------

    def _conv(self, name, x, stride=1, act=True):
        w, b = self.w[name]
        if isinstance(x, _Q):
            wq, sw, b = self._qweights(name, x.scales)
            acc = F.conv2d(x.q, wq, None, stride, w.shape[-1] // 2)
            y = acc * sw[None, :, None, None] + b[None, :, None, None]
            if not act:
                return y
            s = self._scale(name)
            return _Q(self._quant(_silu(y), s), np.full(w.shape[0], s))
        y = F.conv2d(x, w, b, stride, w.shape[-1] // 2)
        if act:
            y = _silu(y)
            self._note(name, y)
        return y

    def _add(self, name, a, b):
        if isinstance(a, _Q):
            s = self._scale(name)
            return _Q(self._quant(a.dequant() + b.dequant(), s), np.full(a.scales.shape, s))
        y = a + b
        self._note(name, y)
        return y

    @staticmethod
    def _cat(parts):
        if isinstance(parts[0], _Q):
            return _Q(torch.cat([p.q for p in parts], 1), np.concatenate([p.scales for p in parts]))
        return torch.cat(parts, 1)

    @staticmethod
    def _map(fn, x):
        return _Q(fn(x.q), x.scales) if isinstance(x, _Q) else fn(x)

    def _split(self, x, c):
        if isinstance(x, _Q):
            return _Q(x.q[:, :c], x.scales[:c]), _Q(x.q[:, c:], x.scales[c:])
        return x[:, :c], x[:, c:]

    def _c2f(self, name, x, shortcut):
        y = self._conv(f"{name}.cv1", x)
        c = (y.q if isinstance(y, _Q) else y).shape[1] // 2
        parts = list(self._split(y, c))
        for i in range(self.depth[name]):
            z = self._conv(f"{name}.m_{i}.cv2", self._conv(f"{name}.m_{i}.cv1", parts[-1]))
            parts.append(self._add(f"{name}.m_{i}.__add__", parts[-1], z) if shortcut else z)
        return self._conv(f"{name}.cv2", self._cat(parts))

    def _sppf(self, name, x):
        pools = [self._conv(f"{name}.cv1", x)]
        for _ in range(3):
            pools.append(self._map(lambda t: F.max_pool2d(t, 5, 1, 2), pools[-1]))
        return self._conv(f"{name}.cv2", self._cat(pools))

    def _graph(self, x):
        self._note("__input__", x)
        if self.bits:
            s = self._scale("__input__")
            x = _Q(self._quant(x, s), np.full(x.shape[1], s))
        up = lambda t: self._map(lambda u: F.interpolate(u, scale_factor=2, mode="nearest"), t)  # noqa: E731
        x = self._c2f("b2", self._conv("b1", self._conv("b0", x, 2), 2), True)
        p3 = self._c2f("b4", self._conv("b3", x, 2), True)
        p4 = self._c2f("b6", self._conv("b5", p3, 2), True)
        p5 = self._sppf("b9", self._c2f("b8", self._conv("b7", p4, 2), True))
        n4 = self._c2f("n12", self._cat([up(p5), p4]), False)
        n3 = self._c2f("n15", self._cat([up(n4), p3]), False)
        n4o = self._c2f("n18", self._cat([self._conv("n16", n3, 2), n4]), False)
        n5o = self._c2f("n21", self._cat([self._conv("n19", n4o, 2), p5]), False)
        box, cls = [], []
        for i, f in enumerate((n3, n4o, n5o)):
            b = self._conv(f"head.cv2_{i}_1", self._conv(f"head.cv2_{i}_0", f))
            c = self._conv(f"head.cv3_{i}_1", self._conv(f"head.cv3_{i}_0", f))
            box.append(self._conv(f"head.cv2_{i}_2", b, act=False))
            cls.append(self._conv(f"head.cv3_{i}_2", c, act=False))
        return box, cls

    @torch.no_grad()
    def forward(self, x: torch.Tensor):
        """(N, 3, s, s) letterboxed float32 -> per level NCHW box logits
        (N, 4·reg_max, h, w) and class logits (N, nc, h, w), float32."""
        return self._graph(x)

    def decode(self, box, cls, geometry, cam_tl: torch.Tensor):
        """Every anchor: its class logit (N, A) (the largest over classes) and
        its box (N, A, 4) as float64 xywh in arena px (the DFL expectation,
        un-letterboxed, shifted by the (N, 2) camera top-left).  Anchors in
        level order, row-major within a level."""
        scale, top, left = geometry
        logits, boxes = [], []
        for b, c, s in zip(box, cls, STRIDES):
            n, _, h, w = c.shape
            logits.append(c.amax(dim=1).reshape(n, -1))
            d = b.reshape(n, 4, self.reg_max, h * w).permute(0, 3, 1, 2).softmax(-1)
            ltrb = (d * torch.arange(self.reg_max, device=d.device, dtype=d.dtype)).sum(-1)
            gy, gx = torch.meshgrid(torch.arange(h, device=d.device), torch.arange(w, device=d.device), indexing="ij")
            anchor = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1).to(d.dtype) + 0.5
            tl = (anchor[None] - ltrb[..., :2]) * s
            br = (anchor[None] + ltrb[..., 2:]) * s
            boxes.append(torch.cat([tl, br], -1))
        xyxy = torch.cat(boxes, 1).double()
        pad = torch.tensor([left, top], dtype=torch.float64, device=xyxy.device)
        xy = (xyxy[..., :2] - pad) / scale + cam_tl.double()[:, None, :]
        wh = (xyxy[..., 2:] - xyxy[..., :2]) / scale
        return torch.cat(logits, 1).double(), torch.cat([xy, wh], -1)
