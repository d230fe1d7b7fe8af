"""Process pool for host-mode likelihoods (counterpart of
``dynesty_tpu.pool``, the reference ``dynesty.pool.Pool`` interface).

With ``likelihood_mode='host'`` the sampler maps the user's Python
callables over each round's points on the host; given a :class:`Pool`,
that map runs over its worker processes.  The workers receive the user's
functions once, at start-up (:func:`initializer`), and are then handed
only numpy arrays: :func:`loglike_cache` and :func:`prior_transform_cache`
call the cached functions by name.  A spawn context is used, so a worker
starts from a fresh import and never inherits the parent's CUDA state;
nothing sent to it is a tensor, so it never initialises CUDA itself.

Bootstrap realisations of the bounds (``use_pool['update_bound']``) and
the dynamic sampler's Monte Carlo stopping realisations
(``use_pool['stop_function']``) map over the same workers.
"""

import multiprocessing as mp

__all__ = ["Pool", "FunctionCache", "initializer", "loglike_cache",
           "prior_transform_cache"]


class FunctionCache:
    """The user's callables and their bound arguments, one set per
    worker process."""

    loglike = None
    prior_transform = None
    logl_args = ()
    logl_kwargs = {}
    ptform_args = ()
    ptform_kwargs = {}


def initializer(loglike, prior_transform, logl_args, logl_kwargs,
                ptform_args, ptform_kwargs):
    """Store the user's callables in this process's cache."""
    FunctionCache.loglike = loglike
    FunctionCache.prior_transform = prior_transform
    FunctionCache.logl_args = logl_args
    FunctionCache.logl_kwargs = logl_kwargs
    FunctionCache.ptform_args = ptform_args
    FunctionCache.ptform_kwargs = ptform_kwargs


def loglike_cache(x, *args, **kwargs):
    """The cached log-likelihood at ``x``."""
    return FunctionCache.loglike(x, *FunctionCache.logl_args, *args,
                                 **FunctionCache.logl_kwargs, **kwargs)


def prior_transform_cache(x, *args, **kwargs):
    """The cached prior transform at ``x``."""
    return FunctionCache.prior_transform(x, *FunctionCache.ptform_args,
                                         *args,
                                         **FunctionCache.ptform_kwargs,
                                         **kwargs)


class Pool:
    """Context-managed spawn pool of ``njobs`` workers with the user's
    callables cached in each.

    Pass ``pool.loglike`` and ``pool.prior_transform`` to the sampler as
    its functions, with ``likelihood_mode='host'`` and ``pool=pool``.
    """

    def __init__(self, njobs, loglike, prior_transform, logl_args=None,
                 logl_kwargs=None, ptform_args=None, ptform_kwargs=None):
        self.njobs = njobs
        self.size = njobs
        self.loglike_0 = loglike
        self.prior_transform_0 = prior_transform
        self.logl_args = logl_args or ()
        self.logl_kwargs = logl_kwargs or {}
        self.ptform_args = ptform_args or ()
        self.ptform_kwargs = ptform_kwargs or {}
        self.pool = None
        self.loglike = loglike_cache
        self.prior_transform = prior_transform_cache

    def __enter__(self):
        ctx = mp.get_context("spawn")
        initargs = (self.loglike_0, self.prior_transform_0, self.logl_args,
                    self.logl_kwargs, self.ptform_args, self.ptform_kwargs)
        self.pool = ctx.Pool(self.njobs, initializer=initializer,
                             initargs=initargs)
        # the parent's cache too, so that a map without workers works
        initializer(*initargs)
        return self

    def map(self, func, iterable):
        """Ordered map over the workers, one item per task."""
        if self.pool is None:
            return list(map(func, iterable))
        return self.pool.map(func, iterable, chunksize=1)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.pool is not None:
            try:
                self.pool.terminate()
                self.pool.join()
            finally:
                self.pool = None
        return False

    def close(self):
        if self.pool is not None:
            self.pool.close()

    def join(self):
        if self.pool is not None:
            self.pool.join()
