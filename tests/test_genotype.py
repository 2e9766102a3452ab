"""Genotype container tests (reference analog: SnpArrays correctness assumed;
here we test pack/unpack/stat/standardization invariants directly)."""

import numpy as np
import pytest

from mendeliht.genotype.snparray import (
    PackedGenotypes, pack_codes, unpack_codes)
from mendeliht.genotype.plink import read_plink, write_plink_bed
from mendeliht.genotype import maf, grm


def test_pack_unpack_roundtrip(rng):
    codes = rng.choice([0, 1, 2, 3], size=(57, 130)).astype(np.uint8)
    packed = pack_codes(np.ascontiguousarray(codes.T))
    assert np.array_equal(unpack_codes(packed, 57).T, codes)


def test_from_codes_stats(rng):
    n, p = 201, 97
    codes = rng.choice([0, 1, 2, 3], size=(n, p),
                       p=[.4, .05, .3, .25]).astype(np.uint8)
    g = PackedGenotypes.from_codes(codes)
    vals = np.array([0, np.nan, 1, 2.])[codes]
    mu = np.nanmean(vals, axis=0)
    np.testing.assert_allclose(np.asarray(g.mu), mu, atol=1e-6)
    sd = np.sqrt(mu * (1 - mu / 2))
    inv = np.where(sd > 0, 1 / np.where(sd > 0, sd, 1), 0)
    np.testing.assert_allclose(np.asarray(g.inv_sd), inv, atol=1e-5)
    assert g.has_missing
    # standardized dense view: columns have ~0 mean when imputing by mean
    X = g.to_dense_standardized()
    np.testing.assert_allclose(X.mean(axis=0), 0, atol=1e-6)


def test_bed_roundtrip(tmp_path, rng):
    n, p = 83, 45
    codes = rng.choice([0, 1, 2, 3], size=(n, p)).astype(np.uint8)
    bed = tmp_path / "x.bed"
    write_plink_bed(str(bed), codes)
    with open(tmp_path / "x.bim", "w") as f:
        for j in range(p):
            f.write(f"1\tsnp{j+1}\t0\t{j+1}\t1\t2\n")
    with open(tmp_path / "x.fam", "w") as f:
        for i in range(n):
            f.write(f"{i+1}\t1\t0\t0\t1\t-9\n")
    snp = read_plink(str(tmp_path / "x"))
    assert snp.people == n and snp.snps == p
    assert np.array_equal(snp.snparray.to_codes(), codes)


def test_reference_bed_loads():
    snp = read_plink("/root/reference/data/normal")
    assert snp.people == 1000 and snp.snps == 10000
    assert not snp.snparray.has_missing
    m = maf(snp.snparray)
    assert np.all((m >= 0) & (m <= 0.5))


def test_maf_and_grm(rng):
    codes = rng.choice([0, 2, 3], size=(60, 40)).astype(np.uint8)
    g = PackedGenotypes.from_codes(codes)
    G = grm(g, device=False)
    assert G.shape == (60, 60)
    np.testing.assert_allclose(G, G.T, atol=1e-12)
    X = g.to_dense_standardized()
    np.testing.assert_allclose(G, X @ X.T / g.p, atol=1e-10)


def test_grm_device_matches_host(rng):
    """On-device blocked GRM (decode-gather + syrk-shaped matmul) == the
    exact f64 host loop, including missing imputation and a
    ragged final chunk."""
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(70, 53),
                       p=[0.4, 0.1, 0.3, 0.2])
    g = PackedGenotypes.from_codes(codes)
    G0 = grm(g, device=False)
    G1 = grm(g, device=True, chunk=16)       # 53 = 3*16 + ragged 5
    assert G1.shape == (70, 70)
    np.testing.assert_allclose(G1, G0, rtol=2e-5, atol=2e-5)


def test_make_snparray(tmp_path, rng):
    """make_snparray packs {0,1,2} values (nan = missing) and optionally
    writes a .bed (reference export, src/MendelIHT.jl:31)."""
    from mendeliht import make_snparray
    vals = rng.choice([0.0, 1.0, 2.0, np.nan], size=(40, 25),
                      p=[0.4, 0.3, 0.2, 0.1])
    bed = str(tmp_path / "mk")
    g = make_snparray(bed + ".bed", vals)
    assert g.n == 40 and g.p == 25
    codes = unpack_codes(np.asarray(g.packed), g.n)
    vmap = {0: 0.0, 2: 1.0, 3: 2.0}
    dec = np.vectorize(lambda c: vmap.get(c, np.nan))(codes).T
    np.testing.assert_array_equal(np.isnan(dec), np.isnan(vals))
    np.testing.assert_array_equal(dec[~np.isnan(vals)], vals[~np.isnan(vals)])
    from mendeliht import make_bim_fam_files
    make_bim_fam_files(g, np.zeros(g.n), bed)
    g2 = read_plink(bed)
    assert np.array_equal(np.asarray(g2.snparray.packed), np.asarray(g.packed))


def test_bgen_zstd_layout2(tmp_path):
    """Synthetic zstd-compressed BGEN v1.2 (layout 2) round-trips: the
    reference ingests these via BGEN.jl; round 2 left zstd gated behind
    NotImplementedError (ADVICE/VERDICT parity gap, reference
    src/wrapper.jl:462-468)."""
    import struct
    import numpy as np
    import pytest

    zstd = pytest.importorskip("zstandard")
    from mendeliht.genotype.bgen import read_bgen

    ns = 4
    # per-variant stored probs (p_refref, p_refalt) at nbits=8:
    # s0 hom-REF (d=0), s1 het (d=1), s2 hom-ALT (d=2), s3 missing
    variants = [
        ("1", 100, "rs1", "A", "G",
         [(255, 0), (0, 255), (0, 0), (0, 0)], [False, False, False, True]),
        ("1", 200, "rs2", "C", "T",
         [(0, 0), (255, 0), (0, 255), (128, 64)],
         [False, False, False, False]),
    ]

    def vstr(s):
        b = s.encode()
        return struct.pack("<H", len(b)) + b

    body = b""
    for chrom, pos, rsid, ref, alt, probs, miss in variants:
        body += vstr("v_" + rsid) + vstr(rsid) + vstr(chrom)
        body += struct.pack("<I", pos) + struct.pack("<H", 2)
        for a in (ref, alt):
            ab = a.encode()
            body += struct.pack("<I", len(ab)) + ab
        ploidy = bytes((2 | (0x80 if m else 0)) for m in miss)
        raw = (struct.pack("<IH", ns, 2) + bytes([2, 2]) + ploidy
               + bytes([0, 8])
               + b"".join(bytes(p) for p in probs))
        comp = zstd.ZstdCompressor().compress(raw)
        body += struct.pack("<I", len(comp) + 4) + struct.pack("<I", len(raw))
        body += comp

    flags = 2 | (2 << 2)                      # zstd, layout 2
    header = struct.pack("<IIII4sI", 20, 20, len(variants), ns, b"bgen",
                         flags)
    path = str(tmp_path / "z.bgen")
    with open(path, "wb") as f:
        f.write(header + body)

    G, sample_ids, chrs, poss, vids, refs, alts = read_bgen(path)
    assert G.shape == (ns, 2)
    np.testing.assert_allclose(G[:3, 0], [0.0, 1.0, 2.0], atol=1e-6)
    assert np.isnan(G[3, 0])
    # variant 2: s3 probs (128/255, 64/255) -> ALT dose 2 - (2*pa + pb)
    pa, pb = 128 / 255.0, 64 / 255.0
    np.testing.assert_allclose(G[:, 1], [2.0, 0.0, 1.0, 2 - 2 * pa - pb],
                               atol=1e-6)
    assert list(vids) == ["rs1", "rs2"] and list(alts) == ["G", "T"]


def test_bgen_phased_layout2(tmp_path):
    """Phased layout-2 BGEN: per-haplotype P(first allele); ALT dosage is
    2 - (h1 + h2) (reference's BGEN.jl handles phased data the same way)."""
    import struct
    import numpy as np

    from mendeliht.genotype.bgen import read_bgen

    ns = 3
    # haplotype P(REF): s0 (1,1) -> d=0; s1 (1,0) -> d=1; s2 (0,0) -> d=2
    probs = [(255, 255), (255, 0), (0, 0)]

    def vstr(s):
        b = s.encode()
        return struct.pack("<H", len(b)) + b

    body = vstr("v1") + vstr("rs1") + vstr("1") + struct.pack("<I", 42)
    body += struct.pack("<H", 2)
    for a in ("A", "G"):
        body += struct.pack("<I", 1) + a.encode()
    ploidy = bytes([2] * ns)
    raw = (struct.pack("<IH", ns, 2) + bytes([2, 2]) + ploidy
           + bytes([1, 8]) + b"".join(bytes(p) for p in probs))
    # compression flag 0: block is the raw payload, no dlen prefix
    body += struct.pack("<I", len(raw)) + raw

    flags = 0 | (2 << 2)                     # uncompressed, layout 2
    header = struct.pack("<IIII4sI", 20, 20, 1, ns, b"bgen", flags)
    path = str(tmp_path / "ph.bgen")
    with open(path, "wb") as f:
        f.write(header + body)

    G, *_ = read_bgen(path)
    np.testing.assert_allclose(G[:, 0], [0.0, 1.0, 2.0], atol=1e-6)


def test_merge_plink(tmp_path, rng):
    """merge_plink concatenates per-chromosome trios with identical samples
    (reference: SnpArrays.merge_plink, manuscript UKBB pipeline)."""
    import mendeliht as m

    n = 30
    y = rng.standard_normal(n)
    parts = []
    for c in (1, 2):
        pref = str(tmp_path / f"chr{c}")
        x, _ = m.simulate_random_snparray(pref + ".bed", n, 10 + 5 * c,
                                          rng=rng)
        m.make_bim_fam_files(x, y, pref)
        parts.append(x.to_codes())

    merged = m.merge_plink(str(tmp_path / "chr"), des=str(tmp_path / "all"))
    assert (merged.people, merged.snps) == (n, 35)
    np.testing.assert_array_equal(merged.snparray.to_codes(),
                                  np.concatenate(parts, axis=1))
    # mismatched samples must be rejected
    pref3 = str(tmp_path / "other")
    x3, _ = m.simulate_random_snparray(pref3 + ".bed", n + 4, 7, rng=rng)
    m.make_bim_fam_files(x3, rng.standard_normal(n + 4), pref3)
    with pytest.raises(ValueError):
        m.merge_plink([str(tmp_path / "chr1"), pref3],
                      des=str(tmp_path / "bad"))


def test_merge_plink_natural_order(tmp_path, rng):
    """chr2 must merge before chr10/chr11 (numeric, not lexicographic,
    ordering of the trailing chromosome token), and a destination whose name
    matches the source glob must never be ingested as an input on re-run."""
    import mendeliht as m

    n = 20
    y = rng.standard_normal(n)
    parts = {}
    for c in (1, 2, 10):
        pref = str(tmp_path / f"chr{c}")
        x, _ = m.simulate_random_snparray(pref + ".bed", n, 6 + c, rng=rng)
        m.make_bim_fam_files(x, y, pref)
        parts[c] = x.to_codes()

    des = str(tmp_path / "chr_all")       # matches the chr* glob on re-run
    merged = m.merge_plink(str(tmp_path / "chr"), des=des)
    expect = np.concatenate([parts[1], parts[2], parts[10]], axis=1)
    np.testing.assert_array_equal(merged.snparray.to_codes(), expect)

    # re-run with the previous output present: des must be excluded
    merged2 = m.merge_plink(str(tmp_path / "chr"), des=des)
    assert merged2.snps == merged.snps
    np.testing.assert_array_equal(merged2.snparray.to_codes(), expect)

    with pytest.raises(ValueError):
        m.merge_plink([str(tmp_path / "chr1")], des=str(tmp_path / "chr1"))
