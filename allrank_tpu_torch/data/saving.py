"""Write ranked or clicked slates back to libsvm form, without their
padding (the JAX package's ``data/saving.py``).

The line grammar is that of the JAX package's writers (scikit-learn's
``dump_svmlight_file`` and its C++ writer): ``label qid:N idx:val ...``,
zero-based feature indices, zeros omitted, qids renumbered from 0 in slate
order. The C++ writer (``data/native.py``, ``writer="native"``, the default)
writes each float in its shortest round-trip form, the bytes of the JAX
package's default writer. The Python writer stays as the plain version
(``writer="python"``): nine significant digits (``%.9g``), enough for any
float32 to read back as itself by either package's parser.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.data.native import write_svmlight_native


def write_to_libsvm_without_masked(
    path: str, X: Iterable[np.ndarray], y: Iterable[np.ndarray],
    writer: str = "native"
) -> None:
    """Drop padded documents (y == PADDED_Y_VALUE), renumber the qids
    sequentially and write one line a document with ``writer``, "native"
    (C++) or "python" (the plain version).

    Base pinning, as the JAX package's writers: where column 0 is zero in
    every row, a reader's auto-detection would take the file as one-based
    and shift every column, so the first line carries an explicit ``0:0``
    after its qid."""
    if writer not in ("native", "python"):
        raise ValueError(f"unknown libsvm writer {writer!r} (expected "
                         "'native' or 'python')")
    xs, ys, qids = [], [], []
    for qid, (slate_x, slate_y) in enumerate(zip(X, y)):
        slate_x = np.asarray(slate_x)
        slate_y = np.asarray(slate_y)
        keep = slate_y != PADDED_Y_VALUE
        xs.append(slate_x[keep])
        ys.append(slate_y[keep])
        qids.append(np.repeat(qid, int(keep.sum())))
    flat_x = np.vstack(xs).astype(np.float32)
    flat_qid = np.concatenate(qids)
    if writer == "native":
        write_svmlight_native(flat_x, np.concatenate(ys), flat_qid, path)
        return
    flat_y = np.concatenate(ys).astype(np.float64)
    pin_base = flat_x.shape[0] > 0 and not np.any(flat_x[:, 0])
    dense = " ".join(f"{j}:%.9g" for j in range(flat_x.shape[1]))
    no_zero = flat_x.all(axis=1)
    with open(path, "w") as f:
        for r, (row, label, qid) in enumerate(zip(
                flat_x.tolist(), flat_y.tolist(), flat_qid.tolist())):
            head = f"{label:.16g} qid:{qid}" + (
                " 0:0" if pin_base and r == 0 else "")
            if no_zero[r]:
                f.write(f"{head} {dense % tuple(row)}\n")
            else:
                f.write(head + "".join(f" {j}:{v:.9g}"
                                       for j, v in enumerate(row) if v)
                        + "\n")
