"""Pure-numpy fastText ``.ftz`` inference (language identification).

A copy of ``acav100m_tpu/pipeline/fasttext_ftz.py`` (the port imports nothing of
the JAX package).

The reference's stage-1 language gate is fastText ``lid.176.ftz``
(wheel ``filter/filter.py:123-148``), and the model FILE ships inside the
wheel; the fasttext C++ package need not be installed. This
module reads the quantized model format directly and reproduces supervised
prediction, so the REAL language detector runs here with no native
dependency:

* binary layout (fastText FASTTEXT_VERSION 12): magic/version, args,
  dictionary (words + labels with counts, prune index), quantized input
  matrix (product quantizer: 8 subquantizers x 256 centroids x 2 dims for
  dim=16, plus a 1-d norm quantizer), output matrix (plain float for
  lid.176);
* subword machinery: UTF-8-aware character n-grams (minn..maxn) of
  ``<word>``, FNV-1a hashed into ``bucket`` slots, routed through the
  prune index of the pruned model (hash -> compact row id);
* hierarchical-softmax prediction: the Huffman tree is rebuilt from the
  label counts exactly as fastText's ``Model::buildTree`` (labels are
  stored count-descending, the invariant the two-pointer merge needs),
  and every leaf's log-probability is the sum of its path's binary
  log-sigmoids.

Scope: supervised+hs+quantized-input models (what lid.176.ftz is). Other
configurations raise.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

FASTTEXT_MAGIC = 793712314
EOS = "</s>"
BOW, EOW = "<", ">"
KSUB = 256  # fastText product-quantizer codebook size


class FtzModel:
    def __init__(self, path):
        data = open(path, "rb").read()
        off = 0
        magic, version = struct.unpack_from("<2i", data, off)
        off += 8
        if magic != FASTTEXT_MAGIC:
            raise ValueError(f"not a fastText model: magic {magic}")
        arg_names = ["dim", "ws", "epoch", "minCount", "neg", "wordNgrams",
                     "loss", "model", "bucket", "minn", "maxn", "lrUpdateRate"]
        self.args = dict(zip(arg_names, struct.unpack_from("<12i", data, off)))
        off += 48 + 8  # 12 int32 + double t
        if version >= 11 and self.args["model"] == 3:  # supervised quirk:
            # args::load keeps reading extra fields only for version<11
            pass
        if self.args["model"] != 3:
            raise NotImplementedError("only supervised models")
        if self.args["loss"] != 1:
            raise NotImplementedError("only hierarchical-softmax models")

        # -- dictionary ----------------------------------------------------
        size_, self.nwords, self.nlabels = struct.unpack_from("<3i", data, off)
        off += 12
        off += 16  # ntokens_, pruneidx_size_ read below via count
        (self.pruneidx_size,) = struct.unpack_from("<q", data, off - 8)
        self.words: List[str] = []
        self.counts = np.zeros(size_, np.int64)
        types = np.zeros(size_, np.int8)
        for i in range(size_):
            end = data.index(b"\x00", off)
            self.words.append(data[off:end].decode("utf-8"))
            off = end + 1
            (self.counts[i],) = struct.unpack_from("<q", data, off)
            off += 8
            types[i] = data[off]
            off += 1
        self.word2id = {w: i for i, w in enumerate(self.words)}
        self.labels = [w for i, w in enumerate(self.words) if types[i] == 1]
        self.label_counts = self.counts[types == 1]
        self.pruneidx: Dict[int, int] = {}
        for _ in range(max(self.pruneidx_size, 0)):
            a, b = struct.unpack_from("<2i", data, off)
            off += 8
            self.pruneidx[a] = b

        # -- input matrix (quantized) --------------------------------------
        quant_input = data[off]
        off += 1
        if not quant_input:
            raise NotImplementedError("only quantized-input (.ftz) models")
        self.input_rows, off = self._load_qmatrix(data, off)

        # -- output matrix -------------------------------------------------
        qout = data[off]
        off += 1
        if qout:
            self.output, off = self._load_qmatrix(data, off)
        else:
            m, n = struct.unpack_from("<2q", data, off)
            off += 16
            self.output = np.frombuffer(
                data, np.float32, m * n, off
            ).reshape(m, n).copy()
            off += m * n * 4
        assert off == len(data), f"trailing bytes: {len(data) - off}"

        self._build_tree()
        self._subword_cache: Dict[int, List[int]] = {}

    # -- quantized matrix decode --------------------------------------------
    @staticmethod
    def _load_qmatrix(data, off) -> Tuple[np.ndarray, int]:
        """QMatrix::load -> fully decoded float rows (m, dim)."""
        qnorm = data[off]
        off += 1
        m, n = struct.unpack_from("<2q", data, off)
        off += 16
        (codesize,) = struct.unpack_from("<i", data, off)
        off += 4
        codes = np.frombuffer(data, np.uint8, codesize, off)
        off += codesize
        dim, nsubq, dsub, lastdsub = struct.unpack_from("<4i", data, off)
        off += 16
        cent = np.frombuffer(data, np.float32, dim * KSUB, off)
        off += dim * KSUB * 4
        # decode: row r, subquantizer s -> centroid chunk cent[s][code]
        codes = codes.reshape(m, nsubq)
        rows = np.zeros((m, dim), np.float32)
        pos = 0
        for s in range(nsubq):
            d = dsub if s < nsubq - 1 else lastdsub
            # centroids of subquantizer s start at s*KSUB*dsub (all but the
            # last have dsub dims)
            base = s * KSUB * dsub
            table = cent[base : base + KSUB * d].reshape(KSUB, d)
            rows[:, pos : pos + d] = table[codes[:, s]]
            pos += d
        if qnorm:
            norm_codes = np.frombuffer(data, np.uint8, m, off)
            off += m
            ndim, nnsubq, ndsub, nlast = struct.unpack_from("<4i", data, off)
            off += 16
            ncent = np.frombuffer(data, np.float32, ndim * KSUB, off)
            off += ndim * KSUB * 4
            rows *= ncent[norm_codes][:, None]
        return rows, off

    # -- Huffman tree (Model::buildTree) -------------------------------------
    def _build_tree(self):
        osz = self.nlabels
        counts = self.label_counts
        parent = np.full(2 * osz - 1, -1, np.int64)
        binary = np.zeros(2 * osz - 1, bool)
        left = np.full(2 * osz - 1, -1, np.int64)
        right = np.full(2 * osz - 1, -1, np.int64)
        cnt = np.full(2 * osz - 1, np.int64(10 ** 15))
        cnt[:osz] = counts
        leaf, node = osz - 1, osz
        for i in range(osz, 2 * osz - 1):
            mini = [0, 0]
            for j in range(2):
                # unbuilt internal nodes hold the 1e15 sentinel, so the
                # plain comparison is exactly fastText's
                if leaf >= 0 and cnt[leaf] < cnt[node]:
                    mini[j] = leaf
                    leaf -= 1
                else:
                    mini[j] = node
                    node += 1
            left[i], right[i] = mini
            cnt[i] = cnt[mini[0]] + cnt[mini[1]]
            parent[mini[0]] = i
            parent[mini[1]] = i
            binary[mini[1]] = True
        # per-leaf path (internal-node ids relative to osz) and codes
        self.paths: List[np.ndarray] = []
        self.codes: List[np.ndarray] = []
        for i in range(osz):
            path, code = [], []
            j = i
            while parent[j] != -1:
                path.append(parent[j] - osz)
                code.append(binary[j])
                j = parent[j]
            self.paths.append(np.asarray(path, np.int64))
            self.codes.append(np.asarray(code, bool))

    # -- subwords -------------------------------------------------------------
    @staticmethod
    def _hash(s: bytes) -> int:
        """FNV-1a over SIGNED chars (fastText Dictionary::hash), mod 2^32."""
        h = 2166136261
        for b in s:
            if b >= 128:
                b -= 256  # int8 cast before widening to uint32
            h = ((h ^ (b & 0xFFFFFFFF)) * 16777619) & 0xFFFFFFFF
        return h

    def _compute_subwords(self, word: str) -> List[int]:
        """char ngrams of <word> -> pruned input-row ids
        (Dictionary::computeSubwords + pushHash)."""
        minn, maxn = self.args["minn"], self.args["maxn"]
        bucket = self.args["bucket"]
        w = (BOW + word + EOW).encode("utf-8")
        out: List[int] = []
        i = 0
        size = len(w)
        while i < size:
            if (w[i] & 0xC0) == 0x80:  # continuation byte: not a char start
                i += 1
                continue
            j, n = i, 1
            ngram = bytearray()
            while j < size and n <= maxn:
                ngram.append(w[j])
                j += 1
                while j < size and (w[j] & 0xC0) == 0x80:
                    ngram.append(w[j])
                    j += 1
                if n >= minn and not (n == 1 and (i == 0 or j == size)):
                    h = self._hash(bytes(ngram)) % bucket
                    if self.pruneidx_size > 0:
                        if h in self.pruneidx:
                            out.append(self.nwords + self.pruneidx[h])
                    elif self.pruneidx_size == 0:
                        out.append(self.nwords + h)
                n += 1
            i += 1
        return out

    def _subwords_of_id(self, wid: int) -> List[int]:
        if wid not in self._subword_cache:
            subs = [wid]
            if self.words[wid] != EOS:
                subs += self._compute_subwords(self.words[wid])
            self._subword_cache[wid] = subs
        return self._subword_cache[wid]

    # -- prediction ------------------------------------------------------------
    def _sentence_vector(self, text: str):
        tokens = text.split() + [EOS]
        ids: List[int] = []
        for tok in tokens:
            wid = self.word2id.get(tok, -1)
            if wid >= 0:
                ids += self._subwords_of_id(wid)
            elif tok != EOS:
                ids += self._compute_subwords(tok)
        if not ids:
            return None
        return self.input_rows[np.asarray(ids, np.int64)].mean(axis=0)

    def predict(self, text: str, k: int = 1):
        """fastText-shaped output: ((label, ...), array(probs))."""
        hidden = self._sentence_vector(text)
        if hidden is None:
            return ((), np.zeros(0, np.float32))
        # internal-node sigmoids once; leaf logprob = sum over its path
        node_scores = self.output[: self.nlabels - 1] @ hidden  # (osz-1,)
        with np.errstate(over="ignore"):
            f = 1.0 / (1.0 + np.exp(-node_scores))
        eps = 1e-12
        log_f = np.log(np.maximum(f, eps))
        log_1mf = np.log(np.maximum(1.0 - f, eps))
        logps = np.asarray([
            (np.where(self.codes[i], log_f[self.paths[i]],
                      log_1mf[self.paths[i]])).sum()
            for i in range(self.nlabels)
        ])
        top = np.argsort(-logps)[:k]
        return (
            tuple(self.labels[i] for i in top),
            np.exp(logps[top]).astype(np.float32),
        )


def load_model(path) -> FtzModel:
    """Drop-in for ``fasttext.load_model`` (predict-only)."""
    return FtzModel(path)
