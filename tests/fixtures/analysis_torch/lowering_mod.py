"""Analysis-linter fixture for the port: the lowering reads ``alpha``,
``beta`` and the ``scaled`` property; ``gamma``, ``delta`` and ``zeta``
are left unread here on purpose."""


def lower(cfg):
    return cfg.alpha + cfg.beta + cfg.scaled
