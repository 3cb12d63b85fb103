"""The port's copy of ``paddle_tpu/dataset/movielens.py``.

MovieLens 1-M (reference: python/paddle/v2/dataset/movielens.py — user
metadata + movie metadata + rating samples parsed from ml-1m.zip).

Sample schema (movielens.py __reader__): ``[user_id, gender(0/1), age_idx,
job_id, movie_id, [category_ids], [title_word_ids], [rating*2-5]]`` — the
recommender-system wide&deep input. Real path parses the cached zip; offline
fallback synthesises a latent-factor world with the same schema so the
recommender demo converges.
"""

import re
import zipfile

import numpy as np

from paddle_tpu_torch.dataset import common

ARCHIVE = "ml-1m.zip"
age_table = [1, 18, 25, 35, 45, 50, 56]

# synthetic-world sizes (used when no cache is present)
_SYN_USERS, _SYN_MOVIES, _SYN_JOBS = 600, 400, 21
_SYN_CATEGORIES, _SYN_TITLE_WORDS = 18, 1000

_meta = None


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, title_dict):
        return [self.index,
                [categories_dict[c] for c in self.categories],
                [title_dict[w.lower()] for w in self.title.split()]]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]


def _load_meta():
    """Parse movies.dat/users.dat once (movielens.py __initialize_meta_info__)."""
    global _meta
    if _meta is not None:
        return _meta
    path = common.cached_file("movielens", ARCHIVE)
    if not path:
        _meta = _synthetic_meta()
        return _meta
    pattern = re.compile(r"^(.*)\((\d+)\)$")
    movies, title_words, categories = {}, set(), set()
    users = {}
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/movies.dat") as f:
            for line in f:
                mid, title, cats = line.decode("latin1").strip().split("::")
                cats = cats.split("|")
                categories.update(cats)
                m = pattern.match(title)
                title = m.group(1).strip() if m else title
                movies[int(mid)] = MovieInfo(mid, cats, title)
                title_words.update(w.lower() for w in title.split())
        with z.open("ml-1m/users.dat") as f:
            for line in f:
                uid, gender, age, job, _zip = \
                    line.decode("latin1").strip().split("::")
                users[int(uid)] = UserInfo(uid, gender, age, job)
    _meta = {
        "movies": movies, "users": users, "real": True,
        "categories": {c: i for i, c in enumerate(sorted(categories))},
        "title_words": {w: i for i, w in enumerate(sorted(title_words))},
    }
    return _meta


def _synthetic_meta():
    rng = np.random.RandomState(1234)
    movies = {
        mid: MovieInfo(mid,
                       [f"c{int(c)}" for c in
                        rng.choice(_SYN_CATEGORIES, 1 + int(rng.randint(3)),
                                   replace=False)],
                       " ".join(f"t{int(w)}" for w in
                                rng.randint(0, _SYN_TITLE_WORDS,
                                            2 + int(rng.randint(4)))))
        for mid in range(1, _SYN_MOVIES + 1)}
    users = {
        uid: UserInfo(uid, "M" if rng.rand() < 0.5 else "F",
                      age_table[int(rng.randint(len(age_table)))],
                      int(rng.randint(_SYN_JOBS)))
        for uid in range(1, _SYN_USERS + 1)}
    cats = sorted({c for m in movies.values() for c in m.categories})
    words = sorted({w.lower() for m in movies.values()
                    for w in m.title.split()})
    return {"movies": movies, "users": users, "real": False,
            "categories": {c: i for i, c in enumerate(cats)},
            "title_words": {w: i for i, w in enumerate(words)}}


def _synthetic_ratings(meta, seed, test_ratio, is_test):
    """Latent-factor ratings: user and movie embeddings drawn from the task
    seed; rating = clipped dot product — learnable structure, not noise."""
    rng = np.random.RandomState(4321)
    uvec = rng.randn(_SYN_USERS + 1, 6)
    mvec = rng.randn(_SYN_MOVIES + 1, 6)
    r = np.random.RandomState(seed)
    for _ in range(16384):
        uid = int(r.randint(1, _SYN_USERS + 1))
        mid = int(r.randint(1, _SYN_MOVIES + 1))
        if (r.rand() < test_ratio) != is_test:
            continue
        raw = float(uvec[uid] @ mvec[mid]) / 2.5 + 0.2 * float(r.randn())
        rating = float(np.clip(np.round(raw + 3.0), 1, 5))
        yield uid, mid, rating


def _reader_creator(rand_seed=0, test_ratio=0.1, is_test=False):
    def reader():
        meta = _load_meta()
        cats, words = meta["categories"], meta["title_words"]
        if meta["real"]:
            path = common.cached_file("movielens", ARCHIVE)
            rand = np.random.RandomState(rand_seed)
            with zipfile.ZipFile(path) as z:
                with z.open("ml-1m/ratings.dat") as f:
                    for line in f:
                        if (rand.rand() < test_ratio) != is_test:
                            continue
                        uid, mid, rating, _ts = \
                            line.decode("latin1").strip().split("::")
                        usr = meta["users"][int(uid)]
                        mov = meta["movies"][int(mid)]
                        yield (usr.value() + mov.value(cats, words) +
                               [[float(rating) * 2 - 5.0]])
        else:
            for uid, mid, rating in _synthetic_ratings(
                    meta, 7 + rand_seed, test_ratio, is_test):
                usr, mov = meta["users"][uid], meta["movies"][mid]
                yield (usr.value() + mov.value(cats, words) +
                       [[rating * 2 - 5.0]])

    meta = _load_meta()
    return (common.real_data(reader) if meta["real"] else
            common.synthetic_fallback(
                "movielens", "test" if is_test else "train", reader))


def train():
    return _reader_creator(is_test=False)


def test():
    return _reader_creator(is_test=True)


def get_movie_title_dict():
    return _load_meta()["title_words"]


def movie_categories():
    return _load_meta()["categories"]


def max_movie_id():
    return max(_load_meta()["movies"])


def max_user_id():
    return max(_load_meta()["users"])


def max_job_id():
    return max(u.job_id for u in _load_meta()["users"].values())


def user_info():
    return _load_meta()["users"]


def movie_info():
    return _load_meta()["movies"]


def convert(path, line_count=1024):
    """Write the dataset as recordio chunks (reference: the
    per-module convert() feeding cloud training)."""
    out = []
    out += common.convert(path, train(), line_count, 'movielens_train')
    out += common.convert(path, test(), line_count, 'movielens_test')
    return out
