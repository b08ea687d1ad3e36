"""The plain reference of the benchmark's configurations, in float32 PyTorch.

Written from the LInKs reference repository's training and serving code
(train_left_right_lifter.py:121-423, train_occlusion_models.py, models_def.py,
FrEIA's AllInOneBlock), independent of the port: it imports nothing of
``links_tpu_torch``, ``links_tpu``, ``jax`` or ``benchmarks``, and takes its
weights as plain state dicts in the reference layout, which the benchmark
makes from the seed (portbench/weights.py).

Every product of a linear layer goes through a ``Products``: ``F32`` is the
reference itself (f32 multiplies, TF32 off); ``BF16`` is the precision the
training configurations state (bf16 operands, f32 sums, and the gradients
that flow back through the operands' casts rounded to bf16, as a cast's
gradient is); ``TF32`` and ``FP8`` are the controls one precision below
what a configuration states for its products (f32 serving, bf16 training),
with each operand rounded to that format before an f32 multiply, in the
forward and the backward (``FP8``: e4m3 operands, e5m2 gradients, each
scaled per tensor, as fp8 training runs). A coupling block's fixed mixing
matrix stays f32, as the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LEFT_IDX = (0, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)
RIGHT_IDX = (0, 1, 2, 3, 7, 8, 9, 10, 14, 15, 16)
# full joint j comes from column COMBINE_COL[j] of the left or the right
# 11-joint split; FROM_RIGHT[choice][j] says which
COMBINE_COL = (0, 1, 2, 3, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 8, 9, 10)
FROM_RIGHT = {"left": (0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1),
              "right": (1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1)}
BONES = ((0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8), (8, 9), (9, 10),
         (8, 11), (11, 12), (12, 13), (8, 14), (14, 15), (15, 16))
BONE_MEANS = {"h36m": (0.5180581, 1.73711136, 1.72285805, 0.5180552, 1.73710543, 1.72285651,
                       0.92087518, 0.98792375, 0.44812302, 0.44502545, 0.57462, 1.08121276,
                       0.9651687, 0.57461556, 1.08122523, 0.9651657)}
LIFTER_POSE = ("res_common", "res_pose1", "res_pose2", "res_pose3")
LIFTER_ANGLE = ("res_angle1", "res_angle2", "res_angle3")
COMPLETER_BLOCKS = ("res_pose1", "res_pose2", "res_pose3")
CLAMP, ATAN = 2.0, 0.636  # FrEIA's clamp and its ATAN activation's literal 0.636


# -- products ------------------------------------------------------------------------------

def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits), to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -8192).view(torch.float32)


def _scaled(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` through ``dtype`` with one scale for the tensor (its largest
    magnitude at the format's ``top``), back in f32."""
    scale = top / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).float() / scale


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (7 mantissa bits), to nearest even, in f32."""
    return t.bfloat16().float()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 (3 mantissa bits), scaled per tensor."""
    return _scaled(t, torch.float8_e4m3fn, 448.0)


def round_fp8_grad(t: torch.Tensor) -> torch.Tensor:
    """A gradient through float8 e5m2 (2 mantissa bits), scaled per tensor."""
    return _scaled(t, torch.float8_e5m2, 57344.0)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class _Rounded(torch.autograd.Function):
    """x @ w^T with both operands rounded, and each product of its backward
    too, the incoming gradient rounded by ``rnd_grad`` and the products'
    results by ``rnd_out``."""

    @staticmethod
    def forward(ctx, x, w, rnd, rnd_grad, rnd_out):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.rnd_grad, ctx.rnd_out = rnd_grad, rnd_out
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.rnd_grad(g)
        return ctx.rnd_out(gq @ wq), ctx.rnd_out(gq.T @ xq), None, None, None


class Products:
    def __init__(self, name: str, rnd=None, rnd_grad=None, rnd_out=_same):
        self.name, self.rnd, self.rnd_grad = name, rnd, rnd_grad or rnd
        self.rnd_out = rnd_out

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w^T, w in (out, in) layout."""
        if self.rnd is None:
            return x @ w.T
        return _Rounded.apply(x, w, self.rnd, self.rnd_grad, self.rnd_out)


F32 = Products("f32")
# the training configurations' own: bf16 operands, f32 sums; the gradient of
# each operand's cast to bf16 is itself rounded to bf16
BF16 = Products("bf16", round_bf16, _same, round_bf16)
TF32 = Products("tf32", round_tf32)
# fp8 training as it is run: e4m3 operands forward, e5m2 gradients backward
FP8 = Products("fp8", round_fp8, round_fp8_grad)


def full_f32():
    """f32 matmuls stay f32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- layers --------------------------------------------------------------------------------

def lrelu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def linear(p: dict, name: str, x, prod: Products):
    return prod.mm(x, p[f"{name}.weight"]) + p[f"{name}.bias"]


def res_block(p: dict, name: str, x, prod: Products):
    h = lrelu(linear(p, f"{name}.l1", x, prod))
    return lrelu(linear(p, f"{name}.l2", h, prod)) + x


def lifter(p: dict, x, prod: Products, angle: bool = True):
    """(B, 2J) -> ((B, J) depth offsets, (B, 1) elevation angle or None)."""
    h = linear(p, "upscale", x, prod)
    h = lrelu(res_block(p, "res_common", h, prod))
    xd = h
    for blk in LIFTER_POSE[1:]:
        xd = lrelu(res_block(p, blk, xd, prod))
    ang = None
    if angle:
        xa = h
        for blk in LIFTER_ANGLE:
            xa = lrelu(res_block(p, blk, xa, prod))
        ang = linear(p, "angles", xa, prod)
    return linear(p, "downscale", xd, prod), ang


def completer(p: dict, x, prod: Products):
    h = linear(p, "upscale", x, prod)
    for blk in COMPLETER_BLOCKS:
        h = lrelu(res_block(p, blk, h, prod))
    return linear(p, "downscale", h, prod)


def _coupling_st(p: dict, k: int, x1, len2: int, prod: Products):
    a = linear(p, f"module_list.{k}.subnet.2",
               torch.relu(linear(p, f"module_list.{k}.subnet.0", x1, prod)), prod) * 0.1
    return CLAMP * ATAN * torch.atan(a[:, :len2]), a[:, len2:]


def _global_scale(p: dict, k: int):
    return 0.1 * (2.0 * F.softplus(0.5 * p[f"module_list.{k}.global_scale"]))


def flow_blocks(p: dict) -> int:
    return sum(1 for key in p if key.endswith(".w_perm"))


def flow_forward(p: dict, x, prod: Products):
    """x -> (z, log|det J|) through FrEIA's AllInOneBlock stack."""
    dim = x.shape[1]
    len2 = dim // 2
    len1 = dim - len2
    logdet = torch.zeros(x.shape[0], device=x.device)
    for k in range(flow_blocks(p)):
        x1, x2 = x[:, :len1], x[:, len1:]
        s, t = _coupling_st(p, k, x1, len2, prod)
        gs = _global_scale(p, k)
        y = torch.cat([x1, x2 * torch.exp(s) + t], dim=1) * gs + p[f"module_list.{k}.global_offset"]
        x = y @ p[f"module_list.{k}.w_perm"].T
        logdet = logdet + (s.sum(-1) + torch.log(gs).sum())
    return x, logdet


def flow_inverse(p: dict, z, prod: Products):
    dim = z.shape[1]
    len2 = dim // 2
    len1 = dim - len2
    for k in reversed(range(flow_blocks(p))):
        gs = _global_scale(p, k)
        y = (z @ p[f"module_list.{k}.w_perm"] - p[f"module_list.{k}.global_offset"]) / gs
        x1, y2 = y[:, :len1], y[:, len1:]
        s, t = _coupling_st(p, k, x1, len2, prod)
        z = torch.cat([x1, (y2 - t) * torch.exp(-s)], dim=1)
    return z


def nll_mean(z, logdet, cap: float):
    v = 0.5 * (z ** 2).sum(-1) - logdet
    if cap:
        v = torch.where(v > cap, cap + torch.log1p(torch.clamp(v - cap, min=0.0)), v)
    return v.mean()


# -- geometry ------------------------------------------------------------------------------

def gather(x, ncoords: int, idx) -> torch.Tensor:
    """Joints ``idx`` of (B, ncoords * 17) poses -> (B, ncoords * len(idx))."""
    x = x.reshape(-1, ncoords, 17)[:, :, list(idx)]
    return x.reshape(x.shape[0], -1)


def combine_depths(left, right, choice: str):
    """(B, 11) + (B, 11) per-joint depths -> (B, 17)."""
    col = list(COMBINE_COL)
    mask = torch.tensor(FROM_RIGHT[choice], dtype=torch.bool, device=left.device)
    return torch.where(mask, right[:, col], left[:, col])


def pin_root(pred):
    return torch.cat([torch.zeros_like(pred[:, :1]), pred[:, 1:]], dim=1)


def rot_x(a):
    """(B, 1) angles -> (B, 3, 3) rotations about x."""
    c, s = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([o, z, z, z, c, -s, z, s, c], dim=-1).reshape(-1, 3, 3)


def rot_y(a):
    c, s = torch.cos(a[:, 0]), torch.sin(a[:, 0])
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1).reshape(-1, 3, 3)


def reconstruct(poses_2d, depth):
    """(B, 34) 2D and (B, 17) depths -> (B, 3, 17) root-centred 3D."""
    p2 = poses_2d.reshape(-1, 2, 17)
    xyz = torch.cat([p2 * depth[:, None, :], depth[:, None, :]], dim=1)
    return xyz - xyz[:, :, :1]


def project(pose_51, depth: float):
    """Root-centred (B, 51), moved ``depth`` along z -> (B, 34) by x/z, y/z."""
    xy = pose_51[:, :34].reshape(-1, 2, 17)
    z = pose_51[:, 34:].reshape(-1, 1, 17) + depth
    return (xy / z).reshape(-1, 34)


def pairwise(pred_3d, re_3d):
    n = pred_3d.shape[0] // 2 * 2
    a = pred_3d.reshape(-1, 51)[:n].reshape(-1, 2, 51)
    b = re_3d[:n].reshape(-1, 2, 51)
    return torch.linalg.vector_norm((a[:, 0] - a[:, 1]) - (b[:, 0] - b[:, 1]), dim=1).mean()


def bone_prior(pred_3d, means):
    p = pred_3d.reshape(-1, 3, 17)
    i, j = [b[0] for b in BONES], [b[1] for b in BONES]
    bl = torch.linalg.vector_norm(p[:, :, i] - p[:, :, j], dim=1)
    rel = bl / bl.mean(dim=1, keepdim=True)
    return ((means - rel) ** 2).sum(dim=1).mean()


# -- the stage-3a loss ---------------------------------------------------------------------

def left_right_loss(lifters: dict, flows: dict, batch, draws, cfg: dict, prod: Products):
    """The stage-3a loss of the side-lifter pair on a (B, 34) batch, with
    ``draws`` = (latent noise (B, 34), azimuth uniforms (2B, 1), elevation
    normals (2B, 1)). ``lifters``: {'left', 'right'} state dicts; ``flows``:
    {'full_flow', 'flow_left', 'flow_right'}. -> the scalar loss."""
    eps, u_azim, eps_elev = draws
    depth = cfg["depth"]
    with torch.no_grad():  # the frozen full flow's samples around the batch
        z, _ = flow_forward(flows["full_flow"], batch, prod)
        samples = flow_inverse(flows["full_flow"], z + cfg["noise_factor"] * eps * z, prod)
        samples = samples.reshape(-1, 2, 17).clone()
        samples[:, :, 0] = 0.0
    inp = torch.cat([batch, samples.reshape(-1, 34)], dim=0)
    n = inp.shape[0]
    ld, la = lifter(lifters["left"], gather(inp, 2, LEFT_IDX), prod)
    rd, ra = lifter(lifters["right"], gather(inp, 2, RIGHT_IDX), prod)
    props = (la + ra) / 2.0
    x_ang = -props.mean() + props.std() * eps_elev
    rot = rot_x(x_ang) @ (rot_y((u_azim - 0.5) * 1.99 * math.pi) @ rot_x(props))
    p3d, rot_poses, rot_2d = {}, {}, {}
    for side in ("left", "right"):
        d = torch.clamp(pin_root(combine_depths(ld, rd, side)) + depth, min=1.0)
        p3d[side] = reconstruct(inp, d)
        rot_poses[side] = (rot @ p3d[side]).reshape(n, 51)
        rot_2d[side] = project(rot_poses[side], depth)
    views = {"left": gather(rot_2d["left"], 2, LEFT_IDX),
             "right": gather(rot_2d["right"], 2, RIGHT_IDX)}
    likeli = sum(nll_mean(*flow_forward(flows[f"flow_{s}"], views[s], prod), cfg["nll_cap"])
                 for s in ("left", "right"))
    # the re-lift of the rotated views: its angles feed no loss
    rld, _ = lifter(lifters["left"], views["left"], prod, angle=False)
    rrd, _ = lifter(lifters["right"], views["right"], prod, angle=False)
    l3d = rep = velocity = prior = 0.0
    means = torch.tensor(BONE_MEANS[cfg["bone_means"]], dtype=torch.float32, device=inp.device)
    for side in ("right", "left"):
        d = torch.clamp(pin_root(combine_depths(rld, rrd, side)) + depth, min=1.0)
        p3d_rot = reconstruct(rot_2d[side], d)
        l3d = l3d + torch.linalg.vector_norm(rot_poses[side] - p3d_rot.reshape(n, 51),
                                             dim=1).mean()
        re_3d = (rot.transpose(1, 2) @ p3d_rot).reshape(n, 51)
        rep = rep + torch.abs(project(re_3d, depth) - inp).sum(dim=1).mean()
        velocity = velocity + pairwise(p3d[side], re_3d)
        prior = prior + bone_prior(p3d[side], means)
    return (cfg["weight_likeli"] * likeli + cfg["weight_2d"] * rep + cfg["weight_3d"] * l3d
            + cfg["weight_velocity"] * velocity + cfg["weight_bl"] * prior)


# -- the stage-4 loss ----------------------------------------------------------------------

def _joints(p, *ranges):
    """Joint ranges of (N, 3, 17) poses, concatenated -> (N, 3 J)."""
    cat = torch.cat([p[:, :, a:b] for a, b in ranges], dim=2)
    return cat.reshape(p.shape[0], -1)


def completer_io(p) -> dict:
    """name -> (input, target) of each completer on (N, 3, 17) poses."""
    return {
        "left_leg": (_joints(p, (0, 4), (7, 17)), _joints(p, (4, 7))),
        "right_leg": (_joints(p, (0, 1), (4, 17)), _joints(p, (1, 4))),
        "left_arm": (_joints(p, (0, 11), (14, 17)), _joints(p, (11, 14))),
        "right_arm": (_joints(p, (0, 14)), _joints(p, (14, 17))),
        "both_legs": (_joints(p, (0, 1), (7, 17)), _joints(p, (1, 7))),
        "torso": (_joints(p, (0, 7)), _joints(p, (7, 17))),
        # a side's completer sees the other side's split
        "left_side": (gather(p.reshape(-1, 51), 3, RIGHT_IDX), _joints(p, (4, 7), (11, 14))),
        "right_side": (gather(p.reshape(-1, 51), 3, LEFT_IDX), _joints(p, (1, 4), (14, 17))),
    }


def pseudo_3d(lifters: dict, batch, depth: float, prod: Products):
    """The frozen legs (joints 0-6) and torso (7-16) lifters' root-centred
    (B, 3, 17) pose of a (B, 34) batch (no depth clamp)."""
    with torch.no_grad():
        legs, _ = lifter(lifters["legs"], gather(batch, 2, range(7)), prod, angle=False)
        torso, _ = lifter(lifters["torso"], gather(batch, 2, range(7, 17)), prod, angle=False)
        return reconstruct(batch, pin_root(torch.cat([legs, torso], dim=1)) + depth)


def occlusion_loss(completers: dict, lifters: dict, batch, u_rot, cfg: dict, prod: Products):
    """The stage-4 loss of the completers ({name: state dict}, in the
    reference's order) on a (B, 34) batch: the frozen lifters' pose and
    ``n_rot`` cumulative y-rotations of it (``u_rot`` (n_rot, B, 1)
    uniforms), each completer's squared error summed over its part and
    meaned over the (n_rot + 1) B rows, times n_rot + 1."""
    poses = [pseudo_3d(lifters, batch, cfg["depth"], prod)]
    for u in u_rot:
        poses.append(rot_y((u - 0.5) * 1.99 * math.pi) @ poses[-1])
    io = completer_io(torch.cat(poses, dim=0))
    scale = float(len(u_rot) + 1)
    return sum(scale * ((completer(completers[name], io[name][0], prod) - io[name][1]) ** 2)
               .sum(dim=1).mean() for name in completers)


# -- serving -------------------------------------------------------------------------------

def lift(lifters: dict, poses_2d, depth: float, choice: str, prod: Products):
    """The left/right lift of (N, 34) normalized 2D -> (N, 51) camera 3D."""
    ld, _ = lifter(lifters["left"], gather(poses_2d, 2, LEFT_IDX), prod, angle=False)
    rd, _ = lifter(lifters["right"], gather(poses_2d, 2, RIGHT_IDX), prod, angle=False)
    z = pin_root(combine_depths(ld, rd, choice)) + depth
    n = poses_2d.shape[0]
    return torch.cat([(poses_2d.reshape(n, 2, 17) * z[:, None, :]).reshape(n, 34), z], dim=1)


# -- Adam ----------------------------------------------------------------------------------

class Adam:
    """Adam as the configurations state it: coupled weight decay added to
    the gradient, b1 0.9, b2 0.999, eps 1e-8, bias correction by the step
    count, the per-epoch staircase learning rate; moments in f32."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, cfg: dict, steps_per_epoch: int):
        self.cfg, self.spe = cfg, steps_per_epoch
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; -> the gradients as the update took
        them (weight decay added)."""
        cfg = self.cfg
        lr = float(torch.tensor(cfg["learning_rate"], dtype=torch.float32)
                   * torch.tensor(cfg["lr_gamma"], dtype=torch.float32)
                   ** float(self.count // self.spe))
        self.count += 1
        bc1 = float(1 - torch.tensor(self.B1, dtype=torch.float32) ** self.count)
        bc2 = float(1 - torch.tensor(self.B2, dtype=torch.float32) ** self.count)
        taken = {}
        for k, p in params.items():
            g = grads[k] + cfg["weight_decay"] * p if cfg["weight_decay"] else grads[k]
            taken[k] = g
            self.mu[k] = self.mu[k] * self.B1 + g * (1 - self.B1)
            self.nu[k] = self.nu[k] * self.B2 + g * g * (1 - self.B2)
            p.add_(-lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.EPS))
        return taken
