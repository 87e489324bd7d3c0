"""Update-hyperparameter optimization (UHO): Bayesian search with GPs.

A copy of the JAX package's `meta/uho.py` (numpy only): a Gaussian process
with Expected Improvement over log-uniform priors, n/2 random initial
points, EI maximized over dense random candidates with local refinement,
CSV logging of every sampled configuration, and best-configuration
selection with the MEDIAN best step over tasks. The one change is
`save_results`, which writes its CSV with the standard `csv` module
instead of pandas (not a dependency of the port): the same header, column
order, rows and float formatting.

The objective is -mean val IoU from early-stopping evaluation
(`meta/uho_eval.EarlyStoppingEvaluator.evaluate_with_early_stopping`).
"""
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

DROPOUT_RATE_NAME = "drop_rate"
AUG_RATE_NAME = "aug_rate"
BATCH_SIZE_NAME = "inner_batch_size"
LEARNING_RATE_NAME = "lr"
SUPPORTED_SEARCH_ALGS = {"GP"}


class Dimension:
    """A search dimension with log-uniform prior support."""

    def __init__(self, low, high, name: str, is_integer: bool = False,
                 prior: str = "log-uniform"):
        assert low < high
        self.name = name
        self.is_integer = is_integer
        self.prior = prior
        self.low, self.high = low, high
        if prior == "log-uniform":
            assert low > 0, "log-uniform prior requires positive bounds"
            self._tlow, self._thigh = math.log(low), math.log(high)
        else:
            self._tlow, self._thigh = float(low), float(high)

    def sample(self, rng: np.random.Generator) -> float:
        t = rng.uniform(self._tlow, self._thigh)
        return self.from_transformed(t)

    def to_transformed(self, value) -> float:
        v = math.log(value) if self.prior == "log-uniform" else float(value)
        return (v - self._tlow) / (self._thigh - self._tlow)

    def from_transformed(self, t) -> float:
        t = min(max(t, self._tlow), self._thigh)
        v = math.exp(t) if self.prior == "log-uniform" else t
        if self.is_integer:
            v = int(round(v))
            v = min(max(v, self.low), self.high)
        return v

    def from_unit(self, u: float):
        return self.from_transformed(self._tlow + u * (self._thigh - self._tlow))


def _rbf_kernel(a: np.ndarray, b: np.ndarray, length_scale: float,
                variance: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return variance * np.exp(-0.5 * d2 / length_scale ** 2)


class GPOptimizer:
    """Minimal ask/tell GP-EI optimizer over unit-cube-normalized dims."""

    def __init__(self, dims: Sequence[Dimension],
                 n_initial_points: int = 10, seed: int = 0,
                 noise: float = 1e-4, n_candidates: int = 2048):
        self.dims = list(dims)
        self.n_initial = n_initial_points
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.n_candidates = n_candidates
        self.X: List[List[float]] = []   # unit-cube coords
        self.y: List[float] = []

    def _unit(self, values: Sequence[float]) -> List[float]:
        return [d.to_transformed(v) for d, v in zip(self.dims, values)]

    def ask(self) -> List[float]:
        if len(self.X) < self.n_initial or len(set(self.y)) < 2:
            return [d.sample(self.rng) for d in self.dims]
        X = np.asarray(self.X)
        y = np.asarray(self.y)
        y_mean, y_std = y.mean(), y.std() + 1e-12
        yn = (y - y_mean) / y_std
        best_length, best_ll, best_alpha, best_K_inv = None, -np.inf, None, None
        for length_scale in (0.1, 0.2, 0.5, 1.0, 2.0):
            K = _rbf_kernel(X, X, length_scale, 1.0)
            K[np.diag_indices_from(K)] += self.noise
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            ll = (-0.5 * yn @ alpha - np.log(np.diag(L)).sum())
            if ll > best_ll:
                K_inv = np.linalg.solve(L.T, np.linalg.solve(
                    L, np.eye(len(X))))
                best_length, best_ll = length_scale, ll
                best_alpha, best_K_inv = alpha, K_inv
        if best_alpha is None:
            return [d.sample(self.rng) for d in self.dims]

        cands = self.rng.uniform(0, 1, (self.n_candidates, len(self.dims)))
        # Local refinement around the incumbent best.
        incumbent = X[np.argmin(yn)]
        local = incumbent + self.rng.normal(0, 0.05,
                                            (self.n_candidates // 4,
                                             len(self.dims)))
        cands = np.clip(np.vstack([cands, local]), 0, 1)

        Ks = _rbf_kernel(cands, X, best_length, 1.0)
        mu = Ks @ best_alpha
        var = np.maximum(1.0 - np.einsum("ij,jk,ik->i", Ks, best_K_inv, Ks),
                         1e-12)
        sigma = np.sqrt(var)
        y_best = yn.min()
        z = (y_best - mu) / sigma
        Phi = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
        phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        ei = sigma * (z * Phi + phi)
        best = cands[int(np.argmax(ei))]
        return [d.from_unit(u) for d, u in zip(self.dims, best)]

    def tell(self, values: Sequence[float], objective: float) -> None:
        self.X.append(self._unit(values))
        self.y.append(float(objective))


# ---------------------------------------------------------------------------
# The search loops.
# ---------------------------------------------------------------------------

def run_m(eval_fn: Callable, params: Dict, m: int = 1):
    all_task_ids, all_num_steps, all_metrics = [], [], []
    for _ in range(m):
        task_ids, num_steps, metrics = eval_fn(**params)
        all_task_ids.extend(task_ids)
        all_num_steps.extend(num_steps)
        all_metrics.extend(metrics)
    return all_task_ids, all_num_steps, all_metrics


def save_results(results, path: str, metric_name: str = "mIoU",
                 append_if_exists: bool = False) -> None:
    """CSV logging of every sampled config: one row per task, the columns
    task_ID, best_num_steps, the metric, then the config's keys."""
    import csv
    formatted: Dict[str, list] = {"task_ID": [], "best_num_steps": [],
                                  metric_name: []}
    for config, (task_ids, num_steps, metrics) in results:
        for key, val in config.items():
            formatted.setdefault(key, []).extend([val] * len(task_ids))
        formatted["task_ID"].extend(task_ids)
        formatted["best_num_steps"].extend(num_steps)
        formatted[metric_name].extend(metrics)
    mode, header = "w", True
    if os.path.exists(path):
        if not append_if_exists:
            i = 0
            while os.path.exists(path + "_{}".format(i)):
                i += 1
            path = path + "_{}".format(i)
        else:
            mode, header = "a", False
    with open(path, mode, newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if header:
            writer.writerow(list(formatted))
        writer.writerows(zip(*formatted.values()))


def compute_best_configuration(results_list, metric_should_increase=True):
    op = (lambda a, b: a > b) if metric_should_increase else (lambda a, b: a < b)
    best_metric = -np.inf if metric_should_increase else np.inf
    best_config, best_step_num = None, None
    for sampled_config, (task_ids, num_steps, metrics) in results_list:
        miou = np.mean(metrics)
        if op(miou, best_metric):
            best_config = sampled_config
            best_metric = miou
            best_step_num = np.median(num_steps)
    return best_config, int(best_step_num), best_metric


def gp_update_hyperparameter_optimization(
        eval_fn: Callable, hyperparams: Dict, search_key_ranges: Dict,
        n: int, save_results_to: Optional[str] = None, m: int = 1,
        metric_should_increase: bool = True,
        n_initial_points: Optional[int] = None, seed: int = 0,
        log_fn=print):
    for key in search_key_ranges:
        assert key in hyperparams, \
            "key: {} not in hyperparams".format(key)
    if n_initial_points is None:
        n_initial_points = int(n / 2)

    dims = []
    for key, domain in search_key_ranges.items():
        if domain[0] == domain[1]:
            continue
        is_int = isinstance(domain[0], int) and isinstance(domain[1], int)
        dims.append(Dimension(domain[0], domain[1], name=key,
                              is_integer=is_int))
    opt = GPOptimizer(dims, n_initial_points=n_initial_points, seed=seed)

    results = []
    for i in range(n):
        sampled_list = opt.ask()
        sampled = {d.name: v for d, v in zip(dims, sampled_list)}
        log_fn("UHO sample {}/{}: {}".format(i + 1, n, sampled))
        hyperparams = dict(hyperparams, **sampled)
        task_ids, num_steps, metrics = run_m(eval_fn, hyperparams, m)
        objective = np.nanmean(metrics)
        if metric_should_increase:
            objective *= -1
        opt.tell(sampled_list, objective)
        results_i = (sampled, (task_ids, num_steps, metrics))
        results.append(results_i)
        log_fn("objective: {}".format(objective))
        if save_results_to is not None:
            save_results([results_i], save_results_to, append_if_exists=True)

    best_config, best_steps, best_metric = compute_best_configuration(
        results, metric_should_increase)
    log_fn("Best mIoU found: {} with median iteration {} and config {}"
           .format(best_metric, best_steps, best_config))
    return best_config, best_steps, best_metric, results


def lr_droprate_aug_rate_batch_size_gp_search(
        eval_fn: Callable, params: Dict,
        lr_search_range_low: float = 0.0005, lr_search_range_high: float = 0.05,
        drop_rate_search_range_low: float = 0.2,
        drop_rate_search_range_high: float = 0.2,
        aug_rate_search_range_low: float = 0.5,
        aug_rate_search_range_high: float = 0.5,
        batch_size_search_range_low: int = 8,
        batch_size_search_range_high: int = 8,
        n: int = 100, save_results_to: Optional[str] = None, m: int = 1,
        metric_should_increase: bool = True, seed: int = 0,
        log_fn=print) -> Tuple[float, int]:
    """The 4-dim search run.sh-style UHO uses; degenerate dims are frozen."""
    def ordered(lo, hi):
        return (hi, lo) if lo > hi else (lo, hi)

    search_key_ranges = {
        LEARNING_RATE_NAME: list(ordered(float(lr_search_range_low),
                                         float(lr_search_range_high))),
        DROPOUT_RATE_NAME: list(ordered(float(drop_rate_search_range_low),
                                        float(drop_rate_search_range_high))),
        AUG_RATE_NAME: list(ordered(float(aug_rate_search_range_low),
                                    float(aug_rate_search_range_high))),
        BATCH_SIZE_NAME: list(ordered(int(batch_size_search_range_low),
                                      int(batch_size_search_range_high))),
    }
    best_config, best_steps, _, _ = gp_update_hyperparameter_optimization(
        eval_fn=eval_fn, hyperparams=params,
        search_key_ranges=search_key_ranges, n=n,
        save_results_to=save_results_to, m=m,
        metric_should_increase=metric_should_increase, seed=seed,
        log_fn=log_fn)
    return float(best_config[LEARNING_RATE_NAME]), int(best_steps)
