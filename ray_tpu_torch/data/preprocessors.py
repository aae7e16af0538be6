"""Dataset preprocessors: fit on a Dataset, transform Datasets/batches (a
copy of the JAX package's `data/preprocessors.py`, over the port's
numpy-block Dataset; it imports numpy and, in FeatureHasher, hashlib).

Parity: `python/ray/data/preprocessors/` (scalers/encoders feeding
Train). Fit statistics stream through `iter_batches` (numpy) so a fit
never materializes the dataset; a fitted preprocessor is a small
picklable object that travels to Train workers and transforms shards
inside the ingest pipeline.
"""

from __future__ import annotations

import numpy as np


class Preprocessor:
    """fit(ds) computes stats; transform(ds) applies them lazily
    (map_batches); transform_batch(dict) applies to one numpy batch."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit before "
                               f"transform")
        # a bound method of a module-level class: it pickles by reference
        return ds.map_batches(self.transform_batch, batch_format="numpy")

    def transform_batch(self, batch: dict) -> dict:
        raise NotImplementedError

    def _fit(self, ds):
        raise NotImplementedError

    def _needs_fit(self) -> bool:
        return True


def _col_stats(ds, columns, want_minmax=False):
    """One streaming pass: per-column n/sum/sumsq (+min/max)."""
    acc = {c: [0, 0.0, 0.0, np.inf, -np.inf] for c in columns}
    for batch in ds.iter_batches(batch_format="numpy"):
        for c in columns:
            v = np.asarray(batch[c], dtype=np.float64)
            a = acc[c]
            a[0] += v.size
            a[1] += float(v.sum())
            a[2] += float((v * v).sum())
            if want_minmax and v.size:
                a[3] = min(a[3], float(v.min()))
                a[4] = max(a[4], float(v.max()))
    return acc


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (population std; std 0 -> 1)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple[float, float]] = {}

    def _fit(self, ds):
        for c, (n, s, ss, _mn, _mx) in _col_stats(ds, self.columns).items():
            mean = s / max(n, 1)
            var = max(ss / max(n, 1) - mean * mean, 0.0)
            std = var ** 0.5
            self.stats_[c] = (mean, std if std > 0 else 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mean, std = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (degenerate range -> 0)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple[float, float]] = {}

    def _fit(self, ds):
        st = _col_stats(ds, self.columns, want_minmax=True)
        for c, (_n, _s, _ss, mn, mx) in st.items():
            self.stats_[c] = (mn, mx)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            mn, mx = self.stats_[c]
            span = (mx - mn) or 1.0
            out[c] = (np.asarray(batch[c], np.float64) - mn) / span
        return out


class OneHotEncoder(Preprocessor):
    """Each categorical column becomes `{col}_{value}` 0/1 columns
    (categories discovered at fit, sorted for determinism; unseen values
    encode as all-zeros)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.categories_: dict[str, list] = {}

    def _fit(self, ds):
        seen: dict[str, set] = {c: set() for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                seen[c].update(np.asarray(batch[c]).tolist())
        self.categories_ = {c: sorted(v, key=repr)
                            for c, v in seen.items()}

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            v = np.asarray(batch[c])
            for cat in self.categories_[c]:
                out[f"{c}_{cat}"] = (v == cat).astype(np.int8)
        return out


class Concatenator(Preprocessor):
    """Pack several numeric columns into one vector column (the shape
    Train ingest wants: one features matrix per batch)."""

    def __init__(self, columns: list[str], output_column_name: str =
                 "concat_out", dtype=np.float32):
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        mats = [np.asarray(batch[c], self.dtype).reshape(
            len(np.asarray(batch[c])), -1) for c in self.columns]
        out[self.output_column_name] = np.concatenate(mats, axis=1)
        return out


class LabelEncoder(Preprocessor):
    """Categorical column -> integer codes (categories discovered at
    fit, sorted; unseen values encode as -1)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: list = []

    def _fit(self, ds):
        seen: set = set()
        for batch in ds.iter_batches(batch_format="numpy"):
            seen.update(np.asarray(batch[self.label_column]).tolist())
        self.classes_ = sorted(seen, key=repr)

    def transform_batch(self, batch):
        out = dict(batch)
        index = {c: i for i, c in enumerate(self.classes_)}
        v = np.asarray(batch[self.label_column])
        out[self.label_column] = np.array(
            [index.get(x, -1) for x in v.tolist()], np.int64)
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with the fit-time mean ("mean") or a constant
    ("constant", fill_value)."""

    def __init__(self, columns: list[str], strategy: str = "mean",
                 fill_value: float = 0.0):
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unknown imputer strategy {strategy!r}")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: dict[str, float] = {}

    def _needs_fit(self) -> bool:
        return self.strategy == "mean"

    def _fit(self, ds):
        if self.strategy != "mean":
            return
        acc = {c: [0, 0.0] for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], np.float64)
                ok = np.isfinite(v)
                acc[c][0] += int(ok.sum())
                acc[c][1] += float(v[ok].sum())
        self.stats_ = {c: (s / n if n else 0.0)
                       for c, (n, s) in acc.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], np.float64).copy()
            fill = (self.stats_.get(c, 0.0) if self.strategy == "mean"
                    else self.fill_value)
            v[~np.isfinite(v)] = fill
            out[c] = v
        return out


class OrdinalEncoder(Preprocessor):
    """Categorical columns -> integer codes in place (like LabelEncoder
    but for feature columns, several at once; unseen values -> -1).
    Parity: preprocessors/encoder.py OrdinalEncoder."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.categories_: dict[str, list] = {}

    def _fit(self, ds):
        seen: dict[str, set] = {c: set() for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                seen[c].update(np.asarray(batch[c]).tolist())
        self.categories_ = {c: sorted(v, key=repr)
                            for c, v in seen.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            index = {v: i for i, v in enumerate(self.categories_[c])}
            out[c] = np.array(
                [index.get(x, -1)
                 for x in np.asarray(batch[c]).tolist()], np.int64)
        return out


class MultiHotEncoder(Preprocessor):
    """List-valued categorical columns -> fixed-width 0/1 vectors over
    the vocabulary discovered at fit (unseen values ignored). Parity:
    preprocessors/encoder.py MultiHotEncoder."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.categories_: dict[str, list] = {}

    def _fit(self, ds):
        seen: dict[str, set] = {c: set() for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                for row in np.asarray(batch[c], dtype=object).tolist():
                    seen[c].update(row)
        self.categories_ = {c: sorted(v, key=repr)
                            for c, v in seen.items()}

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            vocab = self.categories_[c]
            index = {v: i for i, v in enumerate(vocab)}
            rows = np.asarray(batch[c], dtype=object).tolist()
            mat = np.zeros((len(rows), len(vocab)), np.int8)
            for r, row in enumerate(rows):
                for v in row:
                    i = index.get(v)
                    if i is not None:
                        mat[r, i] = 1
            out[c] = mat
        return out


class UniformKBinsDiscretizer(Preprocessor):
    """Bin numeric columns into `bins` equal-width intervals discovered
    from fit-time min/max; values become int bin indices 0..bins-1
    (parity: preprocessors/discretizer.py UniformKBinsDiscretizer)."""

    def __init__(self, columns: list[str], bins: int):
        self.columns = list(columns)
        self.bins = int(bins)
        self.edges_: dict[str, np.ndarray] = {}

    def _fit(self, ds):
        st = _col_stats(ds, self.columns, want_minmax=True)
        for c, (_n, _s, _ss, mn, mx) in st.items():
            if not np.isfinite(mn):
                mn, mx = 0.0, 1.0
            self.edges_[c] = np.linspace(mn, mx, self.bins + 1)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], np.float64)
            # interior edges only; clip so max lands in the last bin
            idx = np.digitize(v, self.edges_[c][1:-1], right=False)
            out[c] = np.clip(idx, 0, self.bins - 1).astype(np.int64)
        return out


class CustomKBinsDiscretizer(Preprocessor):
    """Bin numeric columns using caller-provided edges
    (parity: preprocessors/discretizer.py CustomKBinsDiscretizer).
    `bins` maps column -> monotonically increasing interior edges."""

    def __init__(self, columns: list[str], bins: dict):
        self.columns = list(columns)
        self.bins = {c: np.asarray(bins[c], np.float64) for c in columns}

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], np.float64)
            out[c] = np.digitize(v, self.bins[c]).astype(np.int64)
        return out


class MaxAbsScaler(Preprocessor):
    """x / max(|x|) per column (max-abs 0 -> 1)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, float] = {}

    def _fit(self, ds):
        st = _col_stats(ds, self.columns, want_minmax=True)
        for c, (_n, _s, _ss, mn, mx) in st.items():
            m = max(abs(mn), abs(mx))
            self.stats_[c] = m if m > 0 and np.isfinite(m) else 1.0

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.asarray(batch[c], np.float64) / self.stats_[c]
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column. Quantiles come from a bounded
    reservoir sample (default 100k values/column) — the reference
    computes them with a dataset aggregate; a reservoir keeps the fit
    single-pass and streaming at equivalent accuracy for scaling."""

    def __init__(self, columns: list[str],
                 quantile_range: tuple = (0.25, 0.75),
                 sample_size: int = 100_000):
        self.columns = list(columns)
        self.quantile_range = quantile_range
        self.sample_size = int(sample_size)
        self.stats_: dict[str, tuple[float, float]] = {}

    def _fit(self, ds):
        rng = np.random.default_rng(0)
        res: dict[str, list] = {c: [] for c in self.columns}
        seen: dict[str, int] = {c: 0 for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], np.float64).ravel()
                for x in v:
                    seen[c] += 1
                    if len(res[c]) < self.sample_size:
                        res[c].append(x)
                    else:
                        j = int(rng.integers(0, seen[c]))
                        if j < self.sample_size:
                            res[c][j] = x
        lo, hi = self.quantile_range
        for c, vals in res.items():
            a = np.asarray(vals) if vals else np.zeros(1)
            med = float(np.quantile(a, 0.5))
            iqr = float(np.quantile(a, hi) - np.quantile(a, lo))
            self.stats_[c] = (med, iqr if iqr > 0 else 1.0)

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            med, iqr = self.stats_[c]
            out[c] = (np.asarray(batch[c], np.float64) - med) / iqr
        return out


class Normalizer(Preprocessor):
    """Row-wise normalization of a numeric vector column ("l2", "l1" or
    "max" norm); zero rows pass through (parity:
    preprocessors/normalizer.py)."""

    def __init__(self, columns: list[str], norm: str = "l2"):
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.columns = list(columns)
        self.norm = norm

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            a = np.asarray(batch[c])
            if a.dtype == object:  # column of per-row vectors
                a = np.stack([np.asarray(x, np.float64) for x in a])
            v = a.astype(np.float64)
            m = v.reshape(len(v), -1)
            if self.norm == "l2":
                d = np.sqrt((m * m).sum(axis=1))
            elif self.norm == "l1":
                d = np.abs(m).sum(axis=1)
            else:
                d = np.abs(m).max(axis=1)
            d = np.where(d == 0, 1.0, d)
            out[c] = (m / d[:, None]).reshape(v.shape)
        return out


def _default_tokenize(text: str) -> list[str]:
    return str(text).lower().split()


class Tokenizer(Preprocessor):
    """Text columns -> lists of tokens (default: lowercase whitespace
    split; pass tokenization_fn to override). Parity:
    preprocessors/tokenizer.py."""

    def __init__(self, columns: list[str], tokenization_fn=None):
        self.columns = list(columns)
        self.tokenization_fn = tokenization_fn or _default_tokenize

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = np.array(
                [self.tokenization_fn(t)
                 for t in np.asarray(batch[c]).tolist()], dtype=object)
        return out


class CountVectorizer(Preprocessor):
    """Text column -> one count column per vocabulary token discovered
    at fit (top max_features by total count, alphabetical tiebreak).
    Parity: preprocessors/vectorizer.py CountVectorizer."""

    def __init__(self, columns: list[str], tokenization_fn=None,
                 max_features: int | None = None):
        self.columns = list(columns)
        self.tokenization_fn = tokenization_fn or _default_tokenize
        self.max_features = max_features
        self.vocabularies_: dict[str, list[str]] = {}

    def _fit(self, ds):
        counts: dict[str, dict] = {c: {} for c in self.columns}
        for batch in ds.iter_batches(batch_format="numpy"):
            for c in self.columns:
                for text in np.asarray(batch[c]).tolist():
                    for tok in self.tokenization_fn(text):
                        counts[c][tok] = counts[c].get(tok, 0) + 1
        for c, cnt in counts.items():
            vocab = sorted(cnt, key=lambda t: (-cnt[t], t))
            if self.max_features is not None:
                vocab = vocab[:self.max_features]
            self.vocabularies_[c] = sorted(vocab)

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        for c in self.columns:
            texts = np.asarray(batch[c]).tolist()
            vocab = self.vocabularies_[c]
            index = {t: i for i, t in enumerate(vocab)}
            mat = np.zeros((len(texts), len(vocab)), np.int64)
            for r, text in enumerate(texts):
                for tok in self.tokenization_fn(text):
                    i = index.get(tok)
                    if i is not None:
                        mat[r, i] += 1
            for i, tok in enumerate(vocab):
                out[f"{c}_{tok}"] = mat[:, i]
        return out


class FeatureHasher(Preprocessor):
    """Token-count columns hashed into a fixed `num_features`-wide
    matrix column (the hashing trick: no fit, unbounded vocabulary).
    Input columns hold token lists (e.g. Tokenizer output) or raw text.
    Parity: preprocessors/hasher.py FeatureHasher."""

    def __init__(self, columns: list[str], num_features: int,
                 output_column_name: str = "hashed_features"):
        self.columns = list(columns)
        self.num_features = int(num_features)
        self.output_column_name = output_column_name

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    @staticmethod
    def _hash(token: str, mod: int) -> int:
        import hashlib
        h = hashlib.md5(token.encode()).digest()
        return int.from_bytes(h[:8], "little") % mod

    def transform_batch(self, batch):
        out = {k: v for k, v in batch.items() if k not in self.columns}
        n = len(np.asarray(batch[self.columns[0]], dtype=object))
        mat = np.zeros((n, self.num_features), np.float64)
        for c in self.columns:
            col = np.asarray(batch[c], dtype=object).tolist()
            for r, item in enumerate(col):
                toks = (item if isinstance(item, (list, np.ndarray))
                        else _default_tokenize(item))
                for tok in toks:
                    mat[r, self._hash(str(tok), self.num_features)] += 1
        out[self.output_column_name] = mat
        return out


class HashingVectorizer(FeatureHasher):
    """Alias shape of the reference's HashingVectorizer (text -> hashed
    count matrix); identical mechanics to FeatureHasher here."""


class PowerTransformer(Preprocessor):
    """Power transform with an explicit exponent: method "yeo-johnson"
    (default) or "box-cox" (positive data only), taking `power` as given
    rather than estimating it — the reference's PowerTransformer has the
    same contract (preprocessors/power_transformer.py)."""

    def __init__(self, columns: list[str], power: float,
                 method: str = "yeo-johnson"):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError(f"unknown method {method!r}")
        self.columns = list(columns)
        self.power = float(power)
        self.method = method

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds):
        pass

    def _apply(self, v: np.ndarray) -> np.ndarray:
        lam = self.power
        if self.method == "box-cox":
            if lam == 0:
                return np.log(v)
            return (np.power(v, lam) - 1) / lam
        pos = v >= 0
        out = np.empty_like(v, np.float64)
        if lam == 0:
            out[pos] = np.log1p(v[pos])
        else:
            out[pos] = (np.power(v[pos] + 1, lam) - 1) / lam
        if lam == 2:
            out[~pos] = -np.log1p(-v[~pos])
        else:
            out[~pos] = -(np.power(1 - v[~pos], 2 - lam) - 1) / (2 - lam)
        return out

    def transform_batch(self, batch):
        out = dict(batch)
        for c in self.columns:
            out[c] = self._apply(np.asarray(batch[c], np.float64))
        return out


class Chain(Preprocessor):
    """Apply preprocessors in sequence (fit streams each stage over the
    previous stage's lazy transform)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def _fit(self, ds):
        cur = ds
        for st in self.stages:
            st.fit(cur)
            cur = st.transform(cur)

    def transform_batch(self, batch):
        for st in self.stages:
            batch = st.transform_batch(batch)
        return batch
