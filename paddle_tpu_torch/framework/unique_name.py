"""Unique name generator (counterpart of
``paddle_tpu/framework/unique_name.py``; reference:
python/paddle/fluid/unique_name.py)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def generate_with_ignorable_key(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_generator=None):
    global generator
    if new_generator is None:
        new_generator = UniqueNameGenerator()
    elif isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = generator
    generator = new_generator
    try:
        yield
    finally:
        generator = old


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old
