"""Stage 1 — metadata filtering (tsv -> filtered tsv).

A copy of ``acav100m_tpu/pipeline/metadata_filtering.py`` (the port imports nothing of
the JAX package).

Rebuild of the reference's in-wheel filter
(``metadata_filtering/code/acav_metadata_filter-0.1.0`` wheel,
``filter/filter.py:79-289``): per tsv row parse vid/text/category/duration,
then the rule chain

    duration in [30, 597] -> language in 8 majors -> category==gaming drop
    -> music & artist-keyword drop -> gaming/animation/officialvideo
    keyword drop -> stemmed tutorial keyword drop.

Differences where fasttext, nltk's data files or the network are absent:

* language ID is a protocol — ``FastTextLanguageDetector`` when the package
  + ``lid.176.ftz`` are available, else a built-in heuristic detector
  (script ranges + stopword voting over the 8 major languages);
* tokenization falls back to a regex tokenizer when nltk punkt data is
  absent; stopword lists fall back to built-in minimal sets;
* keyword CSVs are runtime inputs (``keywords_dir``) in the reference's
  format (header line + comma-separated phrases) instead of bundled
  package resources.

This stage is pure host-side text work, exactly like the reference.
"""

from __future__ import annotations

import json
import re
from itertools import chain
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

MAJOR_LANGUAGES = ["en", "es", "pt", "ru", "ja", "fr", "de", "ko"]
DURATION_RANGE = (30, 597)

_URL_RE = re.compile(
    r"(https|http)?:\/\/(\w|\.|\/|\?|\=|\&|\%)*\b", flags=re.MULTILINE
)
_TOKEN_RE = re.compile(r"\w+|[^\w\s]", flags=re.UNICODE)


# -- keyword lists -------------------------------------------------------------

KEYWORD_NAMES = ["animation", "artist", "gaming", "officialvideo", "tutorial"]

# tiny built-in defaults so the stage works with no external keyword files;
# production runs point ``keywords_dir`` at full lists
_DEFAULT_KEYWORDS: Dict[str, List[List[str]]] = {
    "gaming": [["gameplay"], ["game", "play"], ["walkthrough"], ["playthrough"],
               ["let", "'s", "play"], ["speedrun"], ["minecraft"], ["fortnite"]],
    "animation": [["animation"], ["animated"], ["anime"], ["cartoon"]],
    "officialvideo": [["official", "video"], ["official", "music", "video"],
                      ["lyric", "video"], ["official", "audio"]],
    "tutorial": [["tutori"], ["how", "to"], ["diy"], ["lesson"]],
    "artist": [["vevo"], ["official"], ["records"], ["ft", "."], ["feat", "."]],
}


def load_keyword_csv(path) -> List[List[str]]:
    """Reference format (filter.py:45-76): skip header, join columns with
    spaces, lowercase, unique, split into token lists."""
    result = []
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue
            cols = [v for v in line.split(",") if len(v) > 0]
            result.append(" ".join(cols).strip().lower())
    uniq = sorted(set(result))
    return [v.split(" ") for v in uniq if v]


def load_keywords(keywords_dir=None) -> Dict[str, List[List[str]]]:
    if keywords_dir is None:
        return dict(_DEFAULT_KEYWORDS)
    keywords = {}
    for path in sorted(Path(keywords_dir).glob("*.csv")):
        # files are named <name>_keywords.csv
        name = path.stem.replace("_keywords", "")
        keywords[name] = load_keyword_csv(path)
    return keywords


# -- row preprocessing -----------------------------------------------------------

class Preprocessor:
    """tsv row -> (vid, text, category, duration) (filter.py:79-121)."""

    def __call__(self, row: str):
        parts = row.split("\t")
        if len(parts) != 2:
            return None
        vid, data = parts
        try:
            data = json.loads(data)
            fields = data["LatestDAFeature"]
        except Exception:
            return None
        text = self.get_text(fields)
        category = fields.get("YouTubeCategory")
        duration = fields.get("VideoLength")
        if duration and str(duration).isnumeric():
            duration = int(duration) - 1  # VideoLength = Duration + 1
        else:
            duration = (data.get("MediaVersionList") or [{}])[0].get("Duration")
            duration = int(duration) if duration and str(duration).isnumeric() else 0
        return vid, text, category, duration

    @staticmethod
    def get_text(fields: Dict) -> str:
        title = fields.get("Title") if isinstance(fields.get("Title"), str) else ""
        desc = (
            fields.get("Description")
            if isinstance(fields.get("Description"), str)
            else ""
        )
        text = f"{title} {desc}".lower()
        return re.sub(_URL_RE, "", text)


# -- language detection ------------------------------------------------------------

class HeuristicLanguageDetector:
    """Dependency-free language ID over the 8 major languages.

    Script ranges decide ja/ko/ru outright; Latin-script text is voted by
    high-frequency function words per language. Not fastText-accurate, but
    the same protocol — swap in ``FastTextLanguageDetector`` for parity runs.
    """

    _MARKERS = {
        "en": {"the", "and", "of", "to", "in", "is", "you", "that", "it", "for",
               "with", "this", "my", "we", "are"},
        "es": {"el", "la", "de", "que", "y", "en", "los", "del", "las", "por",
               "un", "una", "para", "con", "es"},
        "pt": {"o", "a", "de", "que", "e", "do", "da", "em", "um", "para",
               "com", "uma", "os", "no", "não", "nao"},
        "fr": {"le", "la", "de", "et", "les", "des", "en", "un", "du", "une",
               "que", "est", "pour", "dans", "qui"},
        "de": {"der", "die", "und", "das", "den", "von", "zu", "mit", "ist",
               "im", "für", "fur", "auf", "des", "ein", "eine"},
    }

    def __call__(self, text: str) -> str:
        return self.run(text)

    def run(self, text: str) -> str:
        text = text or ""
        counts = {
            "ja": len(re.findall(r"[぀-ヿㇰ-ㇿ]", text)),
            "ko": len(re.findall(r"[가-힯ᄀ-ᇿ]", text)),
            "ru": len(re.findall(r"[Ѐ-ӿ]", text)),
            "cjk": len(re.findall(r"[一-鿿]", text)),
            "latin": len(re.findall(r"[a-zA-Z]", text)),
        }
        non_latin = {k: counts[k] for k in ("ja", "ko", "ru")}
        best = max(non_latin, key=non_latin.get)
        if non_latin[best] > 0.25 * max(counts["latin"], 1):
            return best
        if counts["cjk"] > 0.5 * max(counts["latin"], 1):
            return "zh"  # chinese -> not a major language here
        tokens = set(re.findall(r"[\w']+", text.lower()))
        votes = {
            lang: len(tokens & markers) for lang, markers in self._MARKERS.items()
        }
        best, score = max(votes.items(), key=lambda kv: kv[1])
        if score == 0:
            # zero marker hits: UNKNOWN, not "en" — defaulting Latin text to
            # English would under-filter (Italian/Dutch/Turkish etc. would
            # pass the major-language gate the reference's fastText rejects).
            # This makes the heuristic STRICTER than fastText on short
            # marker-free titles; parity runs should use the fastText
            # backend.
            return "other"
        return best

    def filter_major(self, text: str) -> bool:
        return self.run(text) in MAJOR_LANGUAGES


class FastTextLanguageDetector:
    """fastText ``lid.176.ftz`` backend (the reference's detector,
    filter.py:123-148). Uses the fasttext package when installed, else the
    bundled pure-numpy ``.ftz`` reader (``fasttext_ftz``) — so the REAL
    model runs even without the native package. Gated only on the model
    file."""

    def __init__(self, model_path):
        try:
            import fasttext

            self.model = fasttext.load_model(str(model_path))
        except ImportError:
            from .fasttext_ftz import load_model

            self.model = load_model(model_path)

    def run(self, text: str) -> str:
        return self.model.predict(text, k=1)[0][0][-2:]

    def __call__(self, text: str) -> str:
        return self.run(text)

    def filter_major(self, text: str) -> bool:
        return self.run(text).lower() in MAJOR_LANGUAGES


def get_language_detector(model_path=None):
    if model_path and Path(model_path).is_file():
        try:
            return FastTextLanguageDetector(model_path)
        except ImportError:
            pass
    return HeuristicLanguageDetector()


# -- stemming / tokenizing -----------------------------------------------------------

_FALLBACK_STOPWORDS = set(
    chain(
        *[
            m
            for m in HeuristicLanguageDetector._MARKERS.values()
        ]
    )
) | {"i", "me", "he", "she", "they", "was", "be", "on", "at", "as", "or", "an"}


class Stemmer:
    """Porter stem + stopword removal (filter.py:150-177)."""

    def __init__(self):
        from nltk.stem import PorterStemmer

        self.stemmer = PorterStemmer()
        self.char_reg = re.compile(r"[a-zA-Z]")
        try:
            from nltk.corpus import stopwords

            langs = ["english", "french", "spanish", "portuguese", "german", "russian"]
            self.stop_words = set(chain(*[stopwords.words(l) for l in langs]))
        except LookupError:
            self.stop_words = set(_FALLBACK_STOPWORDS)

    def __call__(self, text: List[str]) -> List[str]:
        text = [w for w in text if w not in self.stop_words]
        text = [w for w in text if re.search(self.char_reg, w) is not None]
        return [self.stemmer.stem(w) for w in text]


def tokenize(text: str) -> List[str]:
    try:
        import nltk

        return nltk.word_tokenize(text)
    except LookupError:
        return _TOKEN_RE.findall(text)


# -- the filter chain -----------------------------------------------------------------

def is_sublist(long_list: Sequence, short_list: Sequence) -> bool:
    """Contiguous subsequence match (filter.py:198-207)."""
    y = list(short_list)
    if not y:
        return False
    x = list(long_list)
    for i, a in enumerate(x):
        if a == y[0] and x[i : i + len(y)] == y:
            return True
    return False


class MetadataFilter:
    def __init__(self, keywords: Optional[Dict] = None,
                 language_detector=None, keywords_dir=None,
                 fasttext_model=None):
        self.keywords = keywords if keywords is not None else load_keywords(keywords_dir)
        self.language_detector = language_detector or get_language_detector(fasttext_model)
        self.stemmer = Stemmer()

    @staticmethod
    def filter_duration(duration) -> bool:
        lo, hi = DURATION_RANGE
        return lo <= duration <= hi

    def filter_keywords(self, text: List[str], name: str, stem: bool = False) -> bool:
        keywords = self.keywords.get(name, [])
        if stem:
            text = self.stemmer(text)
        for keyword in keywords:
            if is_sublist(text, keyword):
                return False
        return True

    def __call__(self, vid, text, category, duration) -> bool:
        if not self.filter_duration(duration):
            return False
        if not self.language_detector.filter_major(text):
            return False
        toks = tokenize(text)
        if category and category.lower() == "gaming":
            return False
        if category and category.lower() == "music" and not self.filter_keywords(toks, "artist"):
            return False
        if not self.filter_keywords(toks, "gaming"):
            return False
        if not self.filter_keywords(toks, "animation"):
            return False
        if not self.filter_keywords(toks, "officialvideo"):
            return False
        if not self.filter_keywords(toks, "tutorial", stem=True):
            return False
        return True


def test_each(in_path, keywords_dir=None, fasttext_model=None) -> Dict[str, int]:
    """Per-rule drop counts (reference filter.py:239-302 test_each):
    how many rows each individual rule would reject."""
    preprocessor = Preprocessor()
    filt = MetadataFilter(keywords_dir=keywords_dir, fasttext_model=fasttext_model)
    drops: Dict[str, int] = {
        k: 0
        for k in (
            "duration", "language", "category_gaming", "keywords_artist",
            "keywords_gaming", "keywords_animation", "keywords_officialvideo",
            "keywords_tutorial",
        )
    }
    with open(in_path) as in_f:
        for line in in_f:
            fields = preprocessor(line.strip())
            if fields is None:
                continue
            vid, text, category, duration = fields
            drops["duration"] += int(not filt.filter_duration(duration))
            drops["language"] += int(not filt.language_detector.filter_major(text))
            toks = tokenize(text)
            cat = (category or "").lower()
            drops["category_gaming"] += int(cat == "gaming")
            drops["keywords_artist"] += int(
                cat == "music" and not filt.filter_keywords(toks, "artist")
            )
            for name in ("gaming", "animation", "officialvideo"):
                drops[f"keywords_{name}"] += int(
                    not filt.filter_keywords(toks, name)
                )
            drops["keywords_tutorial"] += int(
                not filt.filter_keywords(toks, "tutorial", stem=True)
            )
    return drops


def run_file(in_path, out_path, keywords_dir=None, fasttext_model=None) -> Tuple[int, int]:
    """Stream tsv -> filtered tsv (filter.py:263-280). Returns (kept, total)."""
    preprocessor = Preprocessor()
    filt = MetadataFilter(keywords_dir=keywords_dir, fasttext_model=fasttext_model)
    kept = total = 0
    with open(out_path, "w") as out_f, open(in_path) as in_f:
        for line in in_f:
            total += 1
            fields = preprocessor(line.strip())
            if fields is not None and filt(*fields):
                out_f.write(line)
                kept += 1
    return kept, total
