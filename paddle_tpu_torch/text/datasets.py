"""Text datasets (counterpart of ``paddle_tpu/text/datasets.py``; the
reference's python/paddle/text/datasets: Imdb, UCIHousing, Conll05st,
...). The data is synthetic and seeded, with the reference's shapes and
vocabulary structure, drawn from numpy generators with the JAX package's
seeds, so both packages' datasets are bit-equal. A host numpy copy: no
torch, no device."""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset


class Imdb(Dataset):
    """Binary sentiment dataset shape: (token_ids int64 [seq], label)."""

    def __init__(self, mode: str = "train", cutoff: int = 150,
                 num_samples: int = 1000, vocab_size: int = 5000,
                 seq_len: int = 200):
        seed = 0 if mode == "train" else 1
        rng = np.random.default_rng(seed)
        self._x = rng.integers(1, vocab_size, (num_samples, seq_len),
                               dtype=np.int64)
        # cutoff ≈ the reference's rare-word frequency cutoff: the
        # `cutoff` highest token ids are mapped to OOV (id 0)
        oov_from = max(1, vocab_size - int(cutoff))
        self._x = np.where(self._x >= oov_from, 0, self._x)
        self._y = rng.integers(0, 2, num_samples, dtype=np.int64)
        self.word_idx = {f"w{i}": i for i in range(oov_from)}

    def __len__(self):
        return len(self._y)

    def __getitem__(self, i):
        return self._x[i], self._y[i]


class UCIHousing(Dataset):
    """13 features -> house price regression."""

    def __init__(self, mode: str = "train", num_samples: int = 506):
        rng = np.random.default_rng(0 if mode == "train" else 1)
        self._x = rng.standard_normal((num_samples, 13)).astype(
            np.float32)
        w = rng.standard_normal(13).astype(np.float32)
        self._y = (self._x @ w + 0.1 * rng.standard_normal(
            num_samples)).astype(np.float32).reshape(-1, 1)

    def __len__(self):
        return len(self._y)

    def __getitem__(self, i):
        return self._x[i], self._y[i]


class Conll05st(Dataset):
    """SRL dataset shape: word/predicate/label id sequences."""

    def __init__(self, mode: str = "train", num_samples: int = 500,
                 seq_len: int = 50, vocab_size: int = 2000,
                 num_labels: int = 20):
        rng = np.random.default_rng(0 if mode == "train" else 1)
        self._words = rng.integers(0, vocab_size,
                                   (num_samples, seq_len), np.int64)
        self._preds = rng.integers(0, vocab_size, num_samples, np.int64)
        self._labels = rng.integers(0, num_labels,
                                    (num_samples, seq_len), np.int64)

    def __len__(self):
        return len(self._preds)

    def __getitem__(self, i):
        return self._words[i], self._preds[i], self._labels[i]


class Imikolov(Dataset):
    """PTB-style n-gram LM dataset (reference text/datasets/imikolov.py):
    each item is an n-gram of token ids (data_type=NGRAM) or a (src, trg)
    sequence pair (data_type=SEQ)."""

    def __init__(self, mode: str = "train", data_type: str = "NGRAM",
                 window_size: int = 5, min_word_freq: int = 50,
                 num_samples: int = 2000, vocab_size: int = 2000):
        seed = 0 if mode == "train" else 1
        rng = np.random.default_rng(seed)
        self.data_type = data_type.upper()
        self.window_size = window_size
        if self.data_type not in ("NGRAM", "SEQ"):
            raise ValueError("data_type must be NGRAM or SEQ")
        self._grams = rng.integers(0, vocab_size,
                                   (num_samples, window_size),
                                   dtype=np.int64)
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}

    def __len__(self):
        return len(self._grams)

    def __getitem__(self, i):
        g = self._grams[i]
        if self.data_type == "NGRAM":
            return tuple(g)
        return g[:-1], g[1:]


class Movielens(Dataset):
    """MovieLens rating dataset (reference text/datasets/movielens.py):
    (user_id, gender, age, job, movie_id, title_ids, categories,
    rating)."""

    N_USERS = 600
    N_MOVIES = 1200

    def __init__(self, mode: str = "train", test_ratio: float = 0.1,
                 rand_seed: int = 0, num_samples: int = 2000):
        rng = np.random.default_rng(rand_seed + (0 if mode == "train"
                                                 else 1))
        n = num_samples
        self._user = rng.integers(1, self.N_USERS, n, dtype=np.int64)
        self._gender = rng.integers(0, 2, n, dtype=np.int64)
        self._age = rng.integers(0, 7, n, dtype=np.int64)
        self._job = rng.integers(0, 21, n, dtype=np.int64)
        self._movie = rng.integers(1, self.N_MOVIES, n, dtype=np.int64)
        self._title = rng.integers(1, 5000, (n, 10), dtype=np.int64)
        self._cat = rng.integers(0, 18, (n, 3), dtype=np.int64)
        self._rating = rng.integers(1, 6, n).astype(np.float32)

    def __len__(self):
        return len(self._rating)

    def __getitem__(self, i):
        return (self._user[i], self._gender[i], self._age[i],
                self._job[i], self._movie[i], self._title[i],
                self._cat[i], self._rating[i])


class _WMTBase(Dataset):
    """Shared shape for the WMT translation pairs: (src_ids, trg_ids,
    trg_ids_next)."""

    def __init__(self, mode, src_dict_size, trg_dict_size, seed,
                 num_samples=1000, seq_len=30):
        rng = np.random.default_rng(seed + (0 if mode == "train" else 1))
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size
        self._src = rng.integers(3, src_dict_size,
                                 (num_samples, seq_len), dtype=np.int64)
        self._trg = rng.integers(3, trg_dict_size,
                                 (num_samples, seq_len), dtype=np.int64)

    def __len__(self):
        return len(self._src)

    def __getitem__(self, i):
        trg = self._trg[i]
        return self._src[i], trg, np.roll(trg, -1)

    def get_dict(self, lang="en", reverse=False):
        size = self.src_dict_size if lang == "en" else self.trg_dict_size
        d = {f"w{i}": i for i in range(size)}
        return {v: k for k, v in d.items()} if reverse else d


class WMT14(_WMTBase):
    """WMT'14 en-fr pairs (reference text/datasets/wmt14.py)."""

    def __init__(self, mode: str = "train", dict_size: int = 30000,
                 num_samples: int = 1000):
        super().__init__(mode, dict_size, dict_size, seed=14,
                         num_samples=num_samples)


class WMT16(_WMTBase):
    """WMT'16 en-de pairs (reference text/datasets/wmt16.py)."""

    def __init__(self, mode: str = "train", src_dict_size: int = 30000,
                 trg_dict_size: int = 30000, lang: str = "en",
                 num_samples: int = 1000):
        super().__init__(mode, src_dict_size, trg_dict_size, seed=16,
                         num_samples=num_samples)
