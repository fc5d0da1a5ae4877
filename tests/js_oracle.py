"""Machine-check oracle for the rb3tools port (VERDICT r3 missing-item 3).

No JS runtime exists in this environment (k8 needs v8; node absent; zero
egress), so this module is a deliberately LITERAL, statement-by-statement
transliteration of /root/reference/rb3tools.js (line anchors cited per
function) — including k8 print semantics (tab-joined arguments), JS stable
sorts, and JS regex behavior.  It exists ONLY as a test oracle: the
randomized differential in test_tools_differential.py byte-compares it
against the production port (ropebwt3_jax/tools.py), which was written
independently (round 2) in idiomatic Python.  Agreement over randomized
inputs replaces the round-3 hand-traced fixtures with a machine check.
"""

from __future__ import annotations

import io
import re

RB3_VERSION = "3.10-r283-dirty"  # rb3tools.js:3


def _print(out: io.StringIO, *args) -> None:
    out.write("\t".join(str(a) for a in args) + "\n")


def _readline(text: str):
    # k8_readline (rb3tools.js:79-87): yields lines without the newline
    for line in text.splitlines():
        yield line


def mapflt(text: str, max_hap: int, max_diff: int = 5, gap_size: int = 50) -> str:
    # rb3tools.js:93-130
    out = io.StringIO()
    ctg0, st0, en0, gap = "", 0, 0, 0
    ctg1, st1, en1, n_hap = "", 0, 0, 0
    for line in _readline(text):
        m = re.match(r"^QS\t(\S+):(\d+)-(\d+)\t", line)
        if m is not None:
            ctg1, st1, en1, n_hap = m.group(1), int(m.group(2)) - 1, int(m.group(3)), 0
            continue
        m = re.match(r"^QH\t(\d+)\t(\d+)\t(\d+)", line)
        if m is not None:
            if n_hap > max_hap:
                continue
            if int(m.group(3)) <= max_diff:
                n_hap += int(m.group(1))
        elif line == "//":
            if n_hap > 0 and n_hap <= max_hap:
                continue
            if ctg1 != ctg0 or st1 > en0 + gap_size:
                if ctg0 != "":
                    _print(out, ctg0, st0, en0, gap)
                ctg0, st0, en0, gap = ctg1, st1, en1, 0
            else:
                gap += st1 - en0 if st1 > en0 else 0
                en0 = en0 if en0 > en1 else en1
    if ctg0 != "":
        _print(out, ctg0, st0, en0, gap)
    return out.getvalue()


def _e2e_read1(it, thres1: int, thres2: int):
    # rb3_e2e_read1 (rb3tools.js:132-148)
    r = {"c1": 0, "c2": 0, "ctg": None, "st": -1, "en": -1}
    for line in it:
        m = re.match(r"^QS\t(\S+):(\d+)-(\d+)\t", line)
        if m is not None:
            r["ctg"], r["st"], r["en"] = m.group(1), int(m.group(2)) - 1, int(m.group(3))
            continue
        m = re.match(r"^QH\t(\d+)\t(\d+)\t(\d+)", line)
        if m is not None:
            ed, cnt = int(m.group(3)), int(m.group(1))
            if ed <= thres1:
                r["c1"] += cnt
            if ed <= thres2:
                r["c2"] += cnt
        elif line == "//":
            break
    return r if r["ctg"] is not None else None


def mapflt2(ref_text: str, pan_text: str, max_hap: int, max_rdiff: int = 3, max_pdiff: int = 7, gap_size: int = 50) -> str:
    # rb3tools.js:150-191
    out = io.StringIO()
    fr, fp = _readline(ref_text), _readline(pan_text)
    ctg0, st0, en0, gap = "", 0, 0, 0
    while True:
        r = _e2e_read1(fr, max_rdiff, max_pdiff)
        if r is None:
            break
        p = _e2e_read1(fp, max_rdiff, max_pdiff)
        if p is None:
            raise RuntimeError("more records in the reference e2e file")
        if r["ctg"] != p["ctg"] or r["st"] != p["st"] or r["en"] != p["en"]:
            raise RuntimeError("inconsistent coordinate")
        flt = False
        if r["c1"] == 1 and p["c1"] > 0 and p["c1"] <= max_hap:
            if r["c2"] == 1 and p["c2"] > max_hap:
                flt = True
        else:
            flt = True
        if flt:
            if r["ctg"] != ctg0 or r["st"] > en0 + gap_size:
                if ctg0 != "":
                    _print(out, ctg0, st0, en0, gap)
                ctg0, st0, en0, gap = r["ctg"], r["st"], r["en"], 0
            else:
                gap += r["st"] - en0 if r["st"] > en0 else 0
                en0 = en0 if en0 > r["en"] else r["en"]
    if ctg0 != "":
        _print(out, ctg0, st0, en0, gap)
    return out.getvalue()


class _Allele:  # rb3tools.js:235-240
    def __init__(self, cnt, score, ed):
        self.cnt, self.score, self.ed, self.acc = cnt, score, ed, 0
        self.type = -1


class _KmerVar:  # rb3tools.js:242-247
    def __init__(self, st, en, aid, ref, alt):
        self.st, self.en, self.aid, self.ref, self.alt = st, en, aid, ref, alt
        self.key = f"{self.st}-{self.ref}-{self.alt}"


class _Variant:  # rb3tools.js:249-278
    def __init__(self, kmer_id, ctg, off, length, w):
        self.kmer_id, self.ctg = kmer_id, ctg
        self.st, self.en = off + w.st, off + w.en
        self.ref, self.alt = w.ref, w.alt
        self.end_dist = w.st if w.st < length - w.en else length - w.en
        self.conflict_flt = False
        self.key = f"{self.ctg}-{self.st}-{self.ref}-{self.alt}"
        self.ac_real = self.ac_ambi = self.ac_flt = 0
        self.an_real = self.an_ambi = self.an_flt = 0
        self.rel_score = 0
        self.n_support = 1
        self.type = -1

    def to_string(self, keep_supp1: bool, flag_conflict: bool) -> str:
        info = [f"AC={self.ac_real}", f"AN={self.an_real}", f"AC_AMBI={self.ac_ambi}", f"AN_AMBI={self.an_ambi}",
                f"AC_DUP={self.ac_flt}", f"AN_DUP={self.an_flt}", f"RSCORE={self.rel_score}", f"SUPPORT={self.n_support}"]
        flt = []
        if self.type > 0:
            flt.append("LOWCONF" if self.type == 1 else "AMBI" if self.type == 2 else "DUP")
        if not keep_supp1 and self.n_support < 2:
            flt.append("SUPPORT1")
        if flag_conflict and self.conflict_flt:
            flt.append("CONFLICT")
        if not flt:
            flt.append("PASS")
        if len(self.ref) == len(self.alt):  # SNP
            pos, ref, alt = self.st + 1, self.ref, self.alt
        else:
            pos, ref, alt = self.st, f"N{self.ref}", f"N{self.alt}"
        return "\t".join(str(x) for x in [self.ctg, pos, ".", ref, alt, 60, ";".join(flt), ";".join(info)])


def call(text: str, max_hap: int, ambi_range: int = 4, drop_score: int = 12, max_gced: int = 5,
         keep_supp1: bool = False, flag_conflict: bool = False, dbg: bool = False) -> str:
    # rb3tools.js:193-403
    out = io.StringIO()
    re_cs = re.compile(r"([:=*+-])(\d+|[A-Za-z]+)")

    out.write("##fileformat=VCFv4.2\n")
    out.write(f"##source=rb3tools-{RB3_VERSION}\n")
    out.write('##INFO=<ID=AC,Number=A,Type=Integer,Description="Number of alternate allele">\n')
    out.write('##INFO=<ID=AN,Number=1,Type=Integer,Description="Number of samples">\n')
    out.write('##INFO=<ID=AC_AMBI,Number=A,Type=Integer,Description="Number of ambiguous alleles">\n')
    out.write("##INFO=<ID=AN_AMBI,Number=1,Type=Integer>\n")
    out.write('##INFO=<ID=AC_DUP,Number=A,Type=Integer,Description="Number of duplicate alleles">\n')
    out.write("##INFO=<ID=AN_DUP,Number=1,Type=Integer>\n")
    out.write('##INFO=<ID=RSCORE,Number=1,Type=Integer,Description="Relative k-mer alignment score">\n')
    out.write('##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Number of supporting k-mers">\n')
    out.write('##FILTER=<ID=LOWCONF,Description="Low confidence">\n')
    out.write('##FILTER=<ID=AMBI,Description="Ambiguous">\n')
    out.write('##FILTER=<ID=DUP,Description="Likely caused by duplications">\n')
    out.write('##FILTER=<ID=SUPPORT1,Description="Supported by one k-mer only">\n')
    if flag_conflict:
        out.write('##FILTER=<ID=CONFLICT,Description="Conflictive with a better k-mer alignment">\n')
    _print(out, "#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO")

    kmer_id, vcf, a, al = 0, [], [], []
    ctg1, st1, en1 = "", 0, 0
    for line in _readline(text):
        m = re.match(r"^QS\t(\S+):(\d+)-(\d+)\t", line)
        if m is not None:
            ctg1, st1, en1 = m.group(1), int(m.group(2)) - 1, int(m.group(3))
            a, al = [], []
            continue
        m = re.match(r"^QH\t(\d+)\t(\d+)\t(\d+)\t(\S+)", line)
        if m is not None:
            cnt, score, ed, cs = int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4)
            x, gced, b = 0, 0, []
            for mm in re_cs.finditer(cs):
                op, val = mm.group(1), mm.group(2)
                if op == ":":
                    x += int(val)
                elif op == "*":
                    b.append(_KmerVar(x, x + 1, len(al), val[0].upper(), val[1].upper()))
                    x += 1
                    gced += 1
                elif op == "+":
                    ln = len(val)
                    b.append(_KmerVar(x, x + ln, len(al), val.upper(), ""))
                    x += ln
                    gced += 1
                elif op == "-":
                    b.append(_KmerVar(x, x, len(al), "", val.upper()))
                    gced += 1
            if gced <= max_gced:
                a.extend(b)
                al.append(_Allele(cnt, score, ed))
        elif line == "//":
            if dbg:
                _print(out, "X1", f"{ctg1}:{st1+1}-{en1}")
            while vcf and (vcf[0].ctg != ctg1 or vcf[0].en <= st1):
                out.write(vcf.pop(0).to_string(keep_supp1, flag_conflict) + "\n")
            n_hap = 0
            i, j = 1, 0
            while i <= len(al):
                if i == len(al) or al[i].score != al[j].score:
                    for k in range(j, i):
                        n_hap += al[k].cnt
                    for k in range(j, i):
                        al[k].acc = n_hap
                    j = i
                i += 1
            score_cutoff, score_next = 0, 0
            for t in al:
                if t.acc >= max_hap and score_cutoff == 0:
                    score_cutoff = t.score
                if t.acc > max_hap and score_next == 0:
                    score_next = t.score
            if score_cutoff == 0 and len(al) > 0:
                score_cutoff = al[-1].score
            if dbg:
                _print(out, "X2", score_cutoff, score_next)
            an_real = an_ambi = an_flt = 0
            for t in al:
                if t.score >= score_cutoff and t.score >= score_next + ambi_range:
                    t.type = 0
                    an_real += t.cnt
                elif t.score >= score_cutoff and t.score > score_next:
                    t.type = 1
                    an_real += t.cnt
                elif t.score < score_cutoff - drop_score:
                    t.type = 4
                elif t.score == score_next:
                    t.type = 2
                    an_ambi += t.cnt
                elif t.score < score_next:
                    t.type = 3
                    an_flt += t.cnt
            an_flt += an_real + an_ambi
            an_ambi += an_real
            if score_cutoff == score_next:
                an_real = max_hap
            a.sort(key=lambda x: x.key)  # string compare, stable like JS
            i, j = 1, 0
            while i <= len(a):
                if i == len(a) or a[j].key != a[i].key:
                    v = _Variant(kmer_id, ctg1, st1, en1 - st1, a[j])
                    max_sc, best_type = 0, 4
                    for k in range(j, i):
                        t = al[a[k].aid]
                        best_type = best_type if best_type < t.type else t.type
                        if t.type == 4:
                            continue
                        elif t.type <= 1:
                            v.ac_real += t.cnt
                            v.an_real = 0
                        elif t.type == 2:
                            v.ac_ambi += t.cnt
                        elif t.type == 3:
                            v.ac_flt += t.cnt
                        max_sc = max_sc if max_sc > t.score else t.score
                    if best_type < 4:
                        v.type = best_type
                        v.rel_score = max_sc - score_cutoff
                        v.an_real, v.an_ambi, v.an_flt = an_real, an_ambi, an_flt
                        vcf.append(v)
                    j = i
                i += 1
            wcf = []
            vcf.sort(key=lambda x: (x.st, x.key))  # (st, key), stable
            i, j = 1, 0
            while i <= len(vcf):
                if i == len(vcf) or vcf[j].key != vcf[i].key:
                    n_curr, max_end_dist, max_k, n_support = 0, -1, -1, 0
                    for k in range(j, i):
                        v = vcf[k]
                        if v.kmer_id == kmer_id:
                            n_curr += 1
                        if v.end_dist > max_end_dist:
                            max_end_dist, max_k = v.end_dist, k
                        n_support += v.n_support
                    if n_curr > 1 or max_k < 0:
                        raise RuntimeError("Bug!")
                    v = vcf[max_k]
                    v.n_support = n_support
                    if n_curr == 0:
                        curr_end_dist = v.st - st1 if v.st - st1 < en1 - v.en else en1 - v.en
                        if v.end_dist < curr_end_dist:
                            v.conflict_flt = True
                    wcf.append(v)
                    j = i
                i += 1
            vcf = wcf
            kmer_id += 1
    while vcf:
        out.write(vcf.pop(0).to_string(keep_supp1, flag_conflict) + "\n")
    return out.getvalue()


def getsnp(text: str, auto_only: bool = False) -> str:
    # rb3tools.js:405-431.  JS split("\t", 8) DROPS fields past the limit
    # (unlike Python maxsplit); only t[0..4] are read so slicing suffices.
    out = io.StringIO()
    for line in _readline(text):
        if len(line) == 0 or line[0] == "#":
            continue
        t = line.split("\t")[:8]
        if auto_only and not re.match(r"^(chr\d+|\d+)$", t[0]):
            continue
        ref = t[3]
        for alt in t[4].split(","):
            if len(ref) != len(alt):
                continue
            for k in range(len(ref)):
                if ref[k] != alt[k]:
                    _print(out, "-".join([t[0], t[1], ref[k], alt[k]]))
    return out.getvalue()


def uniqmer(text: str, within_diff: int = 5, min_exact: int = -1, max_exact: int = -1) -> str:
    # rb3tools.js:433-467
    out = io.StringIO()
    name = -1
    for line in _readline(text):
        t = line.split("\t")
        if t[0] == "QS":
            name = t[1]
        elif t[0] == "QH":
            cnt = int(t[3])
            is_excl = False
            if cnt == 0:
                x = int(t[1])
                if max_exact > 0 and x > max_exact:
                    is_excl = True
                if min_exact > 0 and x < min_exact:
                    is_excl = True
            elif cnt > 0 and cnt < within_diff:
                is_excl = True
            if is_excl:
                _print(out, name)
    return out.getvalue()
