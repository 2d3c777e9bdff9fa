"""Faults planted in the program, for checking that the comparison sees
them: the CPU tests plant them under a whole run of the harness, and
`calibrate.py --fault` reads them on the card at a cell's own size. The
benchmark's own runs never plant one. Each takes a pytest-like
`monkeypatch` (an object with setattr)."""
from __future__ import annotations


def state_unchanged(monkeypatch):
    """Every reverse step returns its state unchanged."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    monkeypatch.setattr(KeypointDiffusion, "reverse_step",
                        lambda self, dyn, st, eta=1.0, generator=None, kp_shard=None: st["index"].add_(1))


def half_batch_sample(monkeypatch):
    """The reverse step leaves the second half of the batch out."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    step = KeypointDiffusion.reverse_step

    def half(self, dyn, st, eta=1.0, generator=None, kp_shard=None):
        keep = {k: st[k][st[k].shape[0] // 2:].clone() for k in ("lig_x", "lig_h", "kp_x")}
        step(self, dyn, st, eta, generator, kp_shard)
        for k, v in keep.items():
            st[k][st[k].shape[0] // 2:] = v

    monkeypatch.setattr(KeypointDiffusion, "reverse_step", half)


def answer_altered(monkeypatch):
    """The sampler decodes the last ligand with other elements."""
    import kpdiff_tpu_torch.serve as serve

    decode = serve.decode_ligands

    def altered(out, lig_elements):
        ligands = decode(out, lig_elements)
        coords, elements = ligands[-1]
        ligands[-1] = (coords, ["N" if e != "N" else "O" for e in elements])
        return ligands

    monkeypatch.setattr(serve, "decode_ligands", altered)


def position_altered(monkeypatch):
    """Every reverse step moves one atom of the first row by 1 Å."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    step = KeypointDiffusion.reverse_step

    def nudged(self, dyn, st, eta=1.0, generator=None, kp_shard=None):
        step(self, dyn, st, eta, generator, kp_shard)
        st["lig_x"][0, 0, 0] += 1.0

    monkeypatch.setattr(KeypointDiffusion, "reverse_step", nudged)


def half_batch_loss(monkeypatch):
    """The training loss leaves the second half of the batch out: the mean is
    taken over the first half."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    loss = KeypointDiffusion.loss

    def half(self, cpx, t_eps_override=None, generator=None, kp_shard=None):
        n = cpx.batch_size // 2
        fields = {f: getattr(cpx, f)[:n] for f in ("rec_x", "rec_h", "rec_mask", "rec_res_idx", "lig_x", "lig_h",
                                                   "lig_mask", "kp_x", "kp_h", "kp_mask", "kp_v", "ip_x", "ip_mask")
                  if getattr(cpx, f) is not None}
        te = None if t_eps_override is None else tuple(a[:n] for a in t_eps_override)
        return loss(self, cpx.replace(**fields), t_eps_override=te, generator=generator, kp_shard=kp_shard)

    monkeypatch.setattr(KeypointDiffusion, "loss", half)


def loss_altered(monkeypatch):
    """The training loss's l2 term is read one tenth too high."""
    from kpdiff_tpu_torch.models.diffusion import KeypointDiffusion

    loss = KeypointDiffusion.loss

    def altered(self, *a, **k):
        out = loss(self, *a, **k)
        out["l2"] = out["l2"] * 1.1
        return out

    monkeypatch.setattr(KeypointDiffusion, "loss", altered)


GENERATE = {"state_unchanged": state_unchanged, "half_batch": half_batch_sample,
            "answer_altered": answer_altered, "position_altered": position_altered}
TRAIN = {"half_batch": half_batch_loss, "loss_altered": loss_altered}


class Patch:
    """A minimal monkeypatch for calibrate.py: setattr, undone by undo()."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()
