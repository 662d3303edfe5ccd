"""KMedoids over a distance matrix, in numpy.

Counterpart of ``deepards_tpu/dtw/kmedoids.py`` (the reference's vendored
estimator, deepards/mediods.py:24-433): alternating assign/update with the
deterministic "heuristic" init (the k points of smallest distance sum),
labels assigned from the medoids at the top of each iteration, a medoid
adopted only on a STRICT cost improvement, and convergence when the medoid
set stops changing.  ``init='random'`` and ``init='k-medoids++'`` draw
from ``numpy.random.default_rng(random_state)`` as the JAX package does,
so the same matrix gives the same medoids, labels and inertia.
"""
import numpy as np


class KMedoids:
    def __init__(self, n_clusters=8, metric="euclidean", init="heuristic",
                 max_iter=300, random_state=0):
        self.n_clusters = n_clusters
        self.metric = metric
        self.init = init
        self.max_iter = max_iter
        self.random_state = random_state

    def _distances(self, X):
        X = np.asarray(X, np.float64)
        if self.metric == "precomputed":
            return X
        return np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))

    def _initialize_medoids(self, D, rng):
        if self.init == "random":
            return rng.choice(len(D), self.n_clusters)
        if self.init == "k-medoids++":
            return self._kpp_init(D, rng)
        if self.init == "heuristic":
            # the k points with the smallest sum of distances to the others
            return np.argpartition(
                D.sum(axis=1), self.n_clusters - 1)[: self.n_clusters].copy()
        raise ValueError("init value '{}' not recognized".format(self.init))

    def _kpp_init(self, D, rng):
        """k-means++ seeding over the distance matrix
        (reference: mediods.py:352-433)."""
        centers = np.empty(self.n_clusters, dtype=int)
        n_local_trials = 2 + int(np.log(self.n_clusters))
        centers[0] = rng.integers(D.shape[0])
        closest_dist_sq = D[centers[0], :] ** 2
        current_pot = closest_dist_sq.sum()
        for c in range(1, self.n_clusters):
            rand_vals = rng.random(n_local_trials) * current_pot
            candidate_ids = np.searchsorted(np.cumsum(closest_dist_sq),
                                            rand_vals)
            distance_to_candidates = D[candidate_ids, :] ** 2
            best = None
            for trial in range(n_local_trials):
                new_dist_sq = np.minimum(closest_dist_sq,
                                         distance_to_candidates[trial])
                new_pot = new_dist_sq.sum()
                if best is None or new_pot < best[1]:
                    best = (candidate_ids[trial], new_pot, new_dist_sq)
            centers[c], current_pot, closest_dist_sq = best
        return centers

    def _update_medoids_in_place(self, D, labels, medoids):
        """Per-cluster medoid adoption on STRICT improvement
        (reference: mediods.py:222-255)."""
        for k in range(self.n_clusters):
            members = np.nonzero(labels == k)[0]
            if len(members) == 0:
                continue
            in_cluster_costs = D[np.ix_(members, members)].sum(axis=1)
            min_idx = int(np.argmin(in_cluster_costs))
            pos = np.nonzero(members == medoids[k])[0]
            # A medoid can leave its own cluster when distance ties (such
            # as duplicated points) assign it to a lower-indexed cluster;
            # the reference then costs it as members[0] (mediods.py:248-250,
            # argmax over an all-False mask), and so does this.
            curr_cost = in_cluster_costs[int(pos[0]) if len(pos) else 0]
            if in_cluster_costs[min_idx] < curr_cost:
                medoids[k] = members[min_idx]

    def fit(self, X):
        D = self._distances(X)
        n = D.shape[0]
        if self.n_clusters > n:
            raise ValueError(
                "n_clusters {} > n_samples {}".format(self.n_clusters, n))
        rng = np.random.default_rng(self.random_state)
        medoids = np.asarray(self._initialize_medoids(D, rng))
        labels = None
        for _ in range(self.max_iter):
            old = medoids.copy()
            # ties go to the lower cluster index (reference: mediods.py:192)
            labels = np.argmin(D[medoids, :], axis=0)
            self._update_medoids_in_place(D, labels, medoids)
            if np.array_equal(old, medoids):
                break
        self.medoid_indices_ = medoids
        self.labels_ = labels
        self.inertia_ = float(D[:, medoids].min(axis=1).sum())
        return self

    def predict(self, X):
        return np.argmin(self._distances(X)[:, self.medoid_indices_], axis=1)
