"""Unique name generator (counterpart of `paddle_tpu/unique_name.py`:
`generate`, `guard` and `switch`, copied so that the port's layers mint
the same names, in the same order, as the reference's).

Layer helpers ask for ``generate(key)`` and get ``key_0``, ``key_1``,
...; ``guard()`` runs a block under a fresh counter set and restores
the old one after it, which is how a program is built twice with the
same parameter names.
"""
import contextlib

__all__ = ["generate", "guard", "switch"]


class UniqueNameGenerator:
    def __init__(self):
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None \
        else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
