"""Precomputed-Gram SVC for time-series classification.

Counterpart of :class:`sigkernel_tpu.models.SigKernelSVC`: the workflow of
the reference UEA example, signature-kernel Gram matrices fed to sklearn's
``SVC(kernel="precomputed")`` under ``GridSearchCV``. The two Grams, the
training paths' symmetric one and the test paths' against them, are public
methods on the port's :meth:`.SigKernel.compute_Gram`, so a model-selection
pass can compute them without sklearn; sklearn is imported by :meth:`fit`
alone.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..sigkernel import SigKernel


def _host(a):
    """A tensor or array-like as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class SigKernelSVC:
    """SVC on a precomputed signature-kernel Gram.

    Parameters mirror the reference example: a static kernel, the dyadic
    order, and the SVC hyper-parameter grid. The Grams are solved on the
    paths' device ``max_batch`` paths a side at a time; sklearn's quadratic
    program runs on the host.
    """

    def __init__(self, static_kernel, dyadic_order=0, svc_parameters=None,
                 cv=5, max_batch: Optional[int] = 100, solver="auto"):
        self.sig_kernel = SigKernel(static_kernel, dyadic_order,
                                    solver=solver)
        self.svc_parameters = svc_parameters or {
            "C": np.logspace(0, 4, 5), "gamma": ["auto"]}
        self.cv = cv
        self.max_batch = max_batch
        self._svc = None
        self._X_train = None

    def train_gram(self, X):
        """The symmetric Gram ``(n, n)`` of the training paths ``X``, which
        become the paths :meth:`test_gram` pairs with."""
        self._X_train = X
        return self.sig_kernel.compute_Gram(X, X, sym=True,
                                            max_batch=self.max_batch)

    def test_gram(self, X):
        """The Gram ``(m, n)`` of the paths ``X`` against the training
        paths."""
        if self._X_train is None:
            raise RuntimeError("train_gram() or fit() must be called before "
                               "test_gram()")
        return self.sig_kernel.compute_Gram(X, self._X_train, sym=False,
                                            max_batch=self.max_batch)

    def fit(self, X, y):
        from sklearn.model_selection import GridSearchCV
        from sklearn.svm import SVC

        G = _host(self.train_gram(X))
        svc = SVC(kernel="precomputed", decision_function_shape="ovo")
        self._svc = GridSearchCV(estimator=svc,
                                 param_grid=self.svc_parameters, cv=self.cv)
        self._svc.fit(G, _host(y))
        return self

    def predict(self, X):
        if self._svc is None:
            raise RuntimeError("fit() must be called before predict()")
        return self._svc.predict(_host(self.test_gram(X)))

    def score(self, X, y):
        if self._svc is None:
            raise RuntimeError("fit() must be called before score()")
        return self._svc.score(_host(self.test_gram(X)), _host(y))
