"""The row / column split of the row kernels (csrc/cheap_pass.cu,
csrc/light_augment.cu), held on the CPU against the plain versions it is
compared with on the card, and the kernels' launch plan.

The kernels take each output row back through the applied ops once (its
source row, whether the eraser's rows or the stripe hold it, its row at the
noise stage) and each column once (the column table), and fill a pixel by
the later of the eraser (row and column flags) and the stripe (either
flag); noise and exposure apply at the stages after that fill, in their
order, at counter noise_y * W + noise_x. A torch emulation of that split
lives here (not in the package) and must equal `cheap_pass_reference` and
`fused_light_augment_reference`, which apply the ops one stage after
another, bit for bit. Inputs come from numpy with fixed seeds.
"""
import numpy as np
import pytest
import torch

from mliis_tpu_torch.ops import augment_kernels as tk

ERASER, TRANSLATE, FLIPLR, NOISE, EXPOSURE, ROTATE = range(6)
SHAPES = [(12, 16), (13, 17)]
MAX_SHIFT = 5   # shifts shorter than the small planes' lines


def _walk(ops, vertical, n, vert, shift, roll, eraser=None, flip=FLIPLR,
          translate=TRANSLATE, noise_op=NOISE):
    """Every coordinate of a line of n taken back through `ops`: (source,
    eraser flag, stripe flag, coordinate at the noise stage)."""
    t = torch.arange(n)
    er = torch.zeros(n, dtype=torch.bool)
    st = torch.zeros(n, dtype=torch.bool)
    noise = torch.zeros(n, dtype=torch.int64)
    for op in reversed(ops):
        if op == ERASER and eraser is not None:
            lo, size = eraser
            er = (t >= lo) & (t < lo + size)
        elif op == translate and vert == vertical:
            stripe = t < shift if shift >= 0 else t >= n + shift
            st = stripe & (not roll)
            t = torch.remainder(t - shift, n)
        elif op == flip and not vertical:
            t = n - 1 - t
        elif op == noise_op:
            noise = t.clone()
    return t, er, st, noise


def _normals(bits, key, counter, stream):
    w0, w1 = bits(key, counter.reshape(1, -1), stream)
    return tk._box_muller(tk.uniform_from_bits(w0),
                          tk.uniform_from_bits(w1)).reshape(counter.shape)


def cheap_row_walk(seeds, x, perm, num, window, c_img=3, bits=None,
                   **consts):
    """`cheap_pass` by the row / column split."""
    bits = bits or tk.philox_words
    consts = {**tk._OP_CONSTANTS, **consts}
    b_n, c_tot, h, w = x.shape
    key = seeds.to(torch.int64)[:, None]
    p = tk._draw_cheap_params(key, bits, c_tot, h, w, consts["max_shift"],
                              consts["noise_mean_sd"],
                              consts["exposure_mean_sd"],
                              consts["eraser_s_l"], consts["eraser_s_h"],
                              consts["eraser_r_1"], consts["eraser_r_2"])
    out = torch.empty_like(x)
    for b in range(b_n):
        lo = max(int(window[b, 0]), 0)
        hi = min(int(window[b, 1]), int(num[b]), 6)
        ops = [int(perm[b, s]) for s in range(lo, hi)
               if int(perm[b, s]) != ROTATE]
        stage = {op: i for i, op in enumerate(ops)}
        common = dict(vert=bool(p["vert"][b]), shift=int(p["shift"][b]),
                      roll=bool(p["do_roll"][b]))
        ry, rer, rst, rno = _walk(ops, True, h, eraser=(
            int(p["er_top"][b]), int(p["er_h"][b])), **common)
        cx, cer, cst, cno = _walk(ops, False, w, eraser=(
            int(p["er_left"][b]), int(p["er_w"][b])), **common)
        er = rer[:, None] & cer[None, :]
        st = rst[:, None] | cst[None, :]
        er_stage, tr_stage = stage.get(ERASER, -1), stage.get(TRANSLATE, -1)
        use_er = er & (~st | (er_stage > tr_stage))
        use_st = st & ~use_er
        fill_stage = torch.where(use_er, er_stage,
                                 torch.where(use_st, tr_stage, -1))
        src = x[b][:, ry[:, None], cx[None, :]]
        noise_stage = stage.get(NOISE, -1)
        exp_stage = stage.get(EXPOSURE, -1)
        counter = rno[:, None] * w + cno[None, :]
        noise_on = noise_stage > fill_stage
        exp_on = exp_stage > fill_stage
        exp_last = exp_stage > noise_stage
        for c in range(c_tot):
            if c < c_img:
                v = torch.where(use_er, p["er_c"][b], torch.where(
                    use_st, p["img_fill"][b, c], src[c]))
                shift = p["exp_shift"][b]
                v = torch.where(exp_on & (not exp_last),
                                torch.clamp(v + shift, 0.0, 255.0), v)
                if noise_stage >= 0:
                    g = _normals(bits, key[b:b + 1], counter,
                                 tk.NOISE_STREAM + c)
                    v = torch.where(noise_on, torch.clamp(
                        v + p["noise_sd"][b] * g, 0.0, 255.0), v)
                v = torch.where(exp_on & exp_last,
                                torch.clamp(v + shift, 0.0, 255.0), v)
            else:
                v = torch.where(use_er | use_st, 1.0 if c == c_img else 0.0,
                                src[c])
            out[b, c] = v
    return out


def light_row_walk(seeds, images, masks, prob_original=0.0, bits=None,
                   max_shift=23):
    """`fused_light_augment` by the row / column split."""
    bits = bits or tk.philox_words
    b_n, h, w, _ = images.shape
    key = seeds.to(torch.int64)[:, None]
    p = tk.draw_light_params(seeds, prob_original=prob_original,
                             max_shift=max_shift, bits=bits)
    out_i, out_m = torch.empty_like(images), torch.empty_like(masks)
    for b in range(b_n):
        m = 0 if bool(p["gate"][b]) else int(p["num"][b])
        ops = [int(o) for o in p["ops"][b, :m]]
        stage = {op: i for i, op in enumerate(ops)}
        common = dict(vert=bool(p["vert"][b]), shift=int(p["shift"][b]),
                      roll=bool(p["do_roll"][b]), flip=tk.FLIPLR,
                      translate=tk.TRANSLATE, noise_op=tk.NOISE)
        ry, _, rst, rno = _walk(ops, True, h, **common)
        cx, _, cst, cno = _walk(ops, False, w, **common)
        st = rst[:, None] | cst[None, :]
        fill_stage = torch.where(st, stage.get(tk.TRANSLATE, -1), -1)
        noise_stage = stage.get(tk.NOISE, -1)
        exp_stage = stage.get(tk.EXPOSURE, -1)
        noise_on = (noise_stage > fill_stage)[..., None]
        exp_on = (exp_stage > fill_stage)[..., None]
        exp_last = exp_stage > noise_stage
        v = torch.where(st[..., None], p["fill"][b],
                        images[b][ry[:, None], cx[None, :]])
        shift = p["exp_shift"][b]
        v = torch.where(exp_on & (not exp_last),
                        torch.clamp(v + shift, 0.0, 255.0), v)
        if noise_stage >= 0:
            counter = rno[:, None] * w + cno[None, :]
            g = torch.stack([_normals(bits, key[b:b + 1], counter,
                                      tk.NOISE_STREAM + c)
                             for c in range(3)], -1)
            v = torch.where(noise_on, torch.clamp(
                v + p["noise_sd"][b] * g, 0.0, 255.0), v)
        out_i[b] = torch.where(exp_on & exp_last,
                               torch.clamp(v + shift, 0.0, 255.0), v)
        out_m[b] = torch.round(torch.where(
            st, 0.0, masks[b][ry[:, None], cx[None, :]]))
    return out_i, out_m


def _planar(seed, b, h, w):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 3, h, w)).astype(np.float32)
    fg = (rng.random((b, 1, h, w)) > 0.5).astype(np.float32)
    return torch.from_numpy(np.concatenate([imgs, 1.0 - fg, fg], axis=1))


def _seeds_by_translate(n_wanted=1):
    """{(vertical, roll, shift > 0): seeds} over the cheap draws (which do
    not depend on the plane size)."""
    cand = torch.arange(1, 400, dtype=torch.int64)[:, None]
    p = tk._draw_cheap_params(cand, tk.philox_words, 5, 12, 16, MAX_SHIFT,
                              5.1, 12.75, 0.02, 0.1, 0.3, 1 / 0.3)
    found = {}
    for i in range(cand.shape[0]):
        mode = (bool(p["vert"][i]), bool(p["do_roll"][i]),
                bool(p["shift"][i] > 0))
        found.setdefault(mode, [])
        if len(found[mode]) < n_wanted:
            found[mode].append(int(cand[i, 0]))
    assert len(found) == 8
    return found


def _check_cheap(x, seeds, perm, num, window, **consts):
    args = [torch.as_tensor(np.asarray(a), dtype=torch.int32)
            for a in (seeds, perm, num, window)]
    ref = tk.cheap_pass_reference(args[0], x, *args[1:], **consts)
    emu = cheap_row_walk(args[0], x, *args[1:], **consts)
    assert torch.equal(emu, ref)
    return ref


MODES = [(v, r, d) for v in (True, False) for r in (True, False)
         for d in (True, False)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("op", [ERASER, TRANSLATE, FLIPLR, NOISE, EXPOSURE])
def test_each_op_alone(h, w, op):
    """Each op as the only stage, the translate in all eight modes
    (vertical or horizontal, roll or stripe, either direction)."""
    seeds = [s[0] for s in _seeds_by_translate().values()]
    x = _planar(op, len(seeds), h, w)
    perm = [[op] + [o for o in range(6) if o != op]] * len(seeds)
    ref = _check_cheap(x, seeds, perm, [1] * len(seeds),
                       [[0, 6]] * len(seeds), max_shift=MAX_SHIFT)
    assert not torch.equal(ref, x)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("mode", MODES, ids=[
    "{}-{}-{}".format("v" if v else "h", "roll" if r else "stripe",
                      "pos" if d else "neg") for v, r, d in MODES])
@pytest.mark.parametrize("first", [ERASER, TRANSLATE],
                         ids=["eraser_first", "translate_first"])
def test_eraser_and_translate_orders(h, w, mode, first):
    """The eraser before and after the translate, with a flip and noise
    after both, in every translate mode: the later fill wins."""
    seeds = _seeds_by_translate(3)[mode]
    second = TRANSLATE if first == ERASER else ERASER
    perm = [[first, second, FLIPLR, NOISE, EXPOSURE, ROTATE]] * len(seeds)
    _check_cheap(_planar(7, len(seeds), h, w), seeds, perm,
                 [6] * len(seeds), [[0, 6]] * len(seeds),
                 max_shift=MAX_SHIFT)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("order", [[NOISE, EXPOSURE], [EXPOSURE, NOISE]],
                         ids=["noise_first", "exposure_first"])
def test_noise_and_exposure_orders(h, w, order):
    """Noise before and after exposure, around a stripe translate and the
    eraser, at the default and the short shift."""
    seeds = [s for mode, ss in _seeds_by_translate(2).items() for s in ss]
    b = len(seeds)
    rows = [order + [TRANSLATE, ERASER, FLIPLR, ROTATE],
            [TRANSLATE] + order + [FLIPLR, ERASER, ROTATE]]
    perm = [rows[i % 2] for i in range(b)]
    x = _planar(11, b, h, w)
    _check_cheap(x, seeds, perm, [6] * b, [[0, 6]] * b,
                 max_shift=MAX_SHIFT)
    _check_cheap(x, seeds, perm, [6] * b, [[0, 6]] * b)


@pytest.mark.parametrize("h,w", SHAPES)
def test_every_prefix_length_and_window(h, w):
    """Prefix lengths 0..6, empty and reversed windows, windows that end
    past the prefix, and the two windows around a rotation."""
    rng = np.random.default_rng(3)
    b = 28
    perm = np.stack([rng.permutation(6) for _ in range(b)])
    num = np.arange(b) % 7
    window = np.stack([[0, 6], [2, 2], [4, 1], [1, 6]] * 7)
    rot = np.argmax(perm == ROTATE, axis=1)
    x = _planar(5, b, h, w)
    seeds = rng.integers(0, 2 ** 31 - 1, b)
    _check_cheap(x, seeds, perm, num, window)
    for win in (np.stack([0 * rot, rot], 1), np.stack([rot + 1, 0 * rot + 6],
                                                        1)):
        _check_cheap(x, seeds, perm, num, win, max_shift=MAX_SHIFT)


def test_drawn_rows_and_zero_bits():
    """Rows drawn as the split route draws them, with Philox and with the
    all-zero bit source of the Pallas interpreter."""
    rng = np.random.default_rng(9)
    b = 32
    perm = np.stack([rng.permutation(6) for _ in range(b)])
    num = rng.integers(1, 7, b)
    rot = np.argmax(perm == ROTATE, axis=1)
    x = _planar(9, b, 13, 17)
    seeds = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, b), dtype=torch.int32)
    args = [torch.as_tensor(a, dtype=torch.int32)
            for a in (perm, num, np.stack([0 * rot, rot], 1))]
    for bits in (None, tk.zero_bits):
        ref = tk.cheap_pass_reference(seeds, x, *args, bits=bits)
        assert torch.equal(cheap_row_walk(seeds, x, *args, bits=bits), ref)


def _light_batch(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (b, h, w, 3)).astype(
        np.float32)), torch.from_numpy(rng.integers(0, 1001, (b, h, w)).astype(
            np.float32)))


def _light_seeds():
    """Seeds whose draws cover every op at every stage, every prefix length
    and all eight translate modes."""
    cand = torch.arange(1, 3000, dtype=torch.int32)
    p = tk.draw_light_params(cand, max_shift=MAX_SHIFT)
    want = {}
    for i in range(cand.shape[0]):
        keys = [("num", int(p["num"][i]))]
        keys += [("op at stage", s, int(p["ops"][i, s]))
                 for s in range(int(p["num"][i]))]
        if TRANSLATE in p["ops"][i, :int(p["num"][i])].tolist():
            keys.append(("mode", bool(p["vert"][i]), bool(p["do_roll"][i]),
                         bool(p["shift"][i] > 0)))
        for k in keys:
            want.setdefault(k, int(cand[i]))
    assert len(want) == 4 + 16 + 8
    return torch.tensor(sorted(set(want.values())), dtype=torch.int32)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("prob_original", [0.0, 0.5, 1.0],
                         ids=["no_gate", "half_gate", "all_gate"])
def test_light_split_matches_reference(h, w, prob_original):
    seeds = _light_seeds()
    images, masks = _light_batch(h, len(seeds), h, w)
    ref = tk.fused_light_augment_reference(
        seeds, images, masks, prob_original=prob_original,
        max_shift=MAX_SHIFT)
    emu = light_row_walk(seeds, images, masks, prob_original,
                         max_shift=MAX_SHIFT)
    assert torch.equal(emu[0], ref[0]) and torch.equal(emu[1], ref[1])
    if prob_original == 1.0:
        assert torch.equal(ref[0], images)


@pytest.mark.parametrize("bits", [None, tk.zero_bits],
                         ids=["philox", "zero_bits"])
def test_light_split_default_shift(bits):
    seeds = torch.arange(100, 164, dtype=torch.int32)
    images, masks = _light_batch(1, 64, 13, 17)
    ref = tk.fused_light_augment_reference(seeds, images, masks, bits=bits)
    emu = light_row_walk(seeds, images, masks, bits=bits)
    assert torch.equal(emu[0], ref[0]) and torch.equal(emu[1], ref[1])


PLANS = [("cheap 224^2", 8, 224, 224, tk.ROW_BULK),
         ("cheap 160x224", 8, 160, 224, tk.ROW_BULK),
         ("cheap 320^2", 8, 320, 320, tk.ROW_BULK),
         ("cheap 161x225", 8, 161, 225, tk.ROW_ASYNC),
         ("light B=64 224^2", 64, 224, 224, tk.ROW_BULK),
         ("light 225^2", 8, 225, 225, tk.ROW_ASYNC),
         ("cheap 3x5000", 8, 3, 5000, tk.ROW_DIRECT),
         ("light 4x6000", 2, 4, 6000, tk.ROW_DIRECT)]


@pytest.mark.parametrize("tag,b,h,w,mode", PLANS, ids=[p[0] for p in PLANS])
def test_plan_covers_every_unit_once(tag, b, h, w, mode):
    """The plan's grid and rings fit the card at once (every block's
    shared memory, its static part and the system's share within an SM's,
    no more blocks an SM than the kernel's launch bounds); the unit order is a bijection of the
    B x H x planes units, and the blocks' even runs of it give every
    (sample, row, plane) to one block, each run holding the samples of its
    group evenly."""
    cheap = tag.startswith("cheap")
    planes = 5 if cheap else 1
    plan = (tk.cheap_pass_plan(b, planes, h, w) if cheap
            else tk.light_plan(b, h, w))
    assert plan.mode == mode
    units = b * h * planes
    per_sm = -(-plan.grid // tk.H100_SMS)
    assert per_sm <= (4 if cheap else 2)
    assert per_sm * (plan.smem + 10240 + 1024) <= 233472
    assert plan.grid <= -(-units // 7)
    if mode != tk.ROW_DIRECT:
        assert 1 <= plan.stages <= 32
        stage = _round4(w if cheap else 4 * w)
        assert plan.smem == 512 + 4 * (min(b, tk.ROW_GROUP) * _round4(w)
                                       + (plan.stages + 7) * stage)
    order = [tk.unit_order(u, b, h, planes) for u in range(units)]
    assert sorted(order) == [(s, y, c) for s in range(b) for y in range(h)
                             for c in range(planes)]
    owner = np.zeros(units, np.int64)
    for j in range(plan.grid):
        first, last = j * units // plan.grid, (j + 1) * units // plan.grid
        owner[first:last] += 1
        samples = [order[u][0] for u in range(first, last)]
        counts = np.bincount(samples, minlength=b)
        used = counts[counts > 0]
        # no sample gets a row more than another of the run's group
        assert (used.max() - used.min() <= planes
                or last - first > tk.ROW_GROUP * h * planes)
    assert (owner == 1).all()


def _round4(n):
    return -(-n // 4) * 4


def _affine_columns(ops, n, vert, shift, roll):
    """The kernels' closed-form column walk (`CheapCols`, `LightCols`):
    the (sign, offset) maps x -> (sign x + offset) mod n of the source, the
    noise stage, the translate's stage and the eraser's stage, composed
    backward through one flip and one roll as draw_layout composes them."""
    t, noise, st, er = (1, 0), (0, 0), (0, 0), (0, 0)
    has_st = has_er = False
    for op in reversed(ops):
        if op == ERASER:
            er, has_er = t, True
        elif op == TRANSLATE and not vert:
            st, has_st = t, not roll
            t = (t[0], (t[1] - shift) % n)
        elif op == FLIPLR:
            t = (-t[0], n - 1 - t[1])
        elif op == NOISE:
            noise = t
    return t, noise, st, er, has_st, has_er


def _at(m, x, n):
    return (m[0] * x + m[1]) % n


@pytest.mark.parametrize("n", [16, 17, 5])
@pytest.mark.parametrize("vert", [False, True], ids=["horizontal",
                                                     "vertical"])
@pytest.mark.parametrize("roll", [False, True], ids=["stripe", "roll"])
def test_affine_columns_match_the_walk(n, vert, roll):
    """Every order of every subset of the cheap ops, both translate
    directions and shifts past the line: the closed-form column maps give
    each column's source, noise column, stripe flag and eraser column as
    the op-by-op walk does."""
    import itertools
    x = torch.arange(n)
    lo, size = 2, 3
    for shift in (3, -3, n + 2, -(n + 1)):
        for k in range(5):
            for ops in itertools.permutations(
                    [ERASER, TRANSLATE, FLIPLR, NOISE], k):
                src, er, st, noise = _walk(list(ops), False, n, vert, shift,
                                           roll, eraser=(lo, size))
                t, nm, sm, em, has_st, has_er = _affine_columns(
                    list(ops), n, vert, shift, roll)
                assert torch.equal(_at(t, x, n), src)
                assert torch.equal(_at(nm, x, n), noise)
                ts = _at(sm, x, n)
                stripe = ts < shift if shift >= 0 else ts >= n + shift
                assert torch.equal(stripe & has_st, st)
                ex = _at(em, x, n)
                assert torch.equal((ex >= lo) & (ex < lo + size) & has_er,
                                   er)
