"""Learning-rate schedules as plain functions ``lr_fn(step, base_lr)``.

Counterpart of ``c2matching_tpu/models/lr_scheduler.py``: step decay with
warm restarts (``multi_step_restart_schedule``), cosine annealing with
restarts and an absolute per-group ``eta_min``
(``cosine_annealing_restart_schedule``), the linear warmup that replaces
the schedule's value over the first ``warmup_iter`` steps
(``with_warmup``), and ``build_schedule`` from the YAML ``train`` block.
The same closed forms, on Python floats (the JAX package evaluates them in
float32): ``step`` is the optimizer's 0-indexed schedule count.
"""
import math


def multi_step_restart_schedule(milestones, gamma=0.1, restarts=(0,),
                                restart_weights=(1,)):
    """Step decay with warm restarts. At each milestone the LR is scaled
    by gamma (duplicates compound); a restart at iteration r resets it to
    base_lr * weight and wipes earlier decays; a milestone on a restart
    iteration is skipped. Before the first restart the weight is 1."""
    milestones = sorted(milestones)
    restarts = list(restarts)
    restart_weights = [float(w) for w in restart_weights]
    if len(restarts) != len(restart_weights):
        raise ValueError('restarts and their weights do not match.')
    if not restarts or restarts[0] != 0:
        restarts = [0] + restarts
        restart_weights = [1.0] + restart_weights

    def lr_fn(step, base_lr):
        seg = max(sum(step >= r for r in restarts) - 1, 0)
        n_decays = sum(step >= m for m in milestones if m > restarts[seg])
        return base_lr * restart_weights[seg] * gamma ** n_decays

    return lr_fn


def cosine_annealing_restart_schedule(period, restarts=(),
                                      restart_weights=(), eta_min=0.0):
    """Cosine annealing with restarts: ``period`` has one more entry than
    ``restarts`` (absolute iterations, ascending); segment i starts at
    restart i-1 (or 0) and has period[i] and weight restart_weights[i-1]
    (1 before the first restart). ``eta_min`` is an absolute LR:

        lr = eta_min + w * 0.5 * (base_lr - eta_min)
                     * (1 + cos(pi * (step - segment start) / period))

    not clipped at the period's end."""
    period = [float(p) for p in period]
    restarts = list(restarts)
    restart_weights = [float(w) for w in restart_weights]
    if len(restarts) != len(restart_weights):
        raise ValueError('restarts and their weights do not match.')
    if len(period) - len(restarts) != 1:
        raise ValueError('period should have one more element then restarts.')
    starts = [0] + restarts
    weights = [1.0] + restart_weights

    def lr_fn(step, base_lr):
        seg = sum(step >= r for r in restarts)
        t = float(step - starts[seg])
        return (eta_min + weights[seg] * 0.5 * (base_lr - eta_min)
                * (1 + math.cos(math.pi * t / period[seg])))

    return lr_fn


def with_warmup(lr_fn, warmup_iter=-1):
    """Linear warmup over the first ``warmup_iter`` steps: while
    step + 1 < warmup_iter the LR is base_lr * (step + 1) / warmup_iter,
    replacing the schedule's value; then the schedule takes over. -1 (or
    None, or 0) disables it."""
    if warmup_iter is None or warmup_iter <= 0:
        return lr_fn

    def warmed(step, base_lr):
        if step + 1 < warmup_iter:
            return base_lr * (step + 1) / warmup_iter
        return lr_fn(step, base_lr)

    return warmed


def build_schedule(train_opt):
    """``lr_fn(step, base_lr)`` from the YAML ``train`` block
    (``lr_scheme``: MultiStepLR, MultiStepRestartLR or
    CosineAnnealingRestartLR)."""
    scheme = train_opt.get('lr_scheme', 'MultiStepLR') or 'MultiStepLR'
    if scheme in ('MultiStepLR', 'MultiStepRestartLR'):
        sched = multi_step_restart_schedule(
            train_opt.get('lr_steps') or [],
            gamma=train_opt.get('lr_gamma', 0.1) or 0.1,
            restarts=train_opt.get('restarts') or [0],
            restart_weights=train_opt.get('restart_weights') or [1])
    elif scheme == 'CosineAnnealingRestartLR':
        sched = cosine_annealing_restart_schedule(
            train_opt['period'],
            restarts=train_opt.get('restarts') or [],
            restart_weights=train_opt.get('restart_weights') or [],
            eta_min=float(train_opt.get('eta_min', 0) or 0))
    else:
        raise NotImplementedError(f'lr_scheme {scheme} is not implemented.')
    return with_warmup(sched, train_opt.get('warmup_iter', -1))

