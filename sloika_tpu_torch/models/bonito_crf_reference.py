"""The plain reference of bonito's CRF-LSTM basecaller
(``dna_r9.4.1_e8_hac@v3.3``), in plain PyTorch and float32, written as
bonito's modules compute the network (nanoporetech/bonito,
``bonito/crf/model.py``: ``rnn_encoder``, ``LinearCRFEncoder``) and as
seqdist's ``CTC_CRF`` decodes it (``posteriors``, then ``viterbi`` on the
logs of the posteriors plus 1e-8, then ``path_to_str``).  It imports
nothing but ``torch`` and the standard library: no kernel of the port and
nothing of JAX.

The network over a (T, B, 1) batch of signal rows valid up to ``lengths``:

* three convolutions ``swish(conv1d(x, W, b, stride, padding=w // 2))``:
  1 -> 4 and 4 -> 16 of width 5, 16 -> features of width 19 and stride 5;
* five ``torch.nn.LSTM`` cells of ``features`` (gates i, f, g, o from
  ``W_ih x + b_ih + W_hh h + b_hh``; ``c' = sig(f) c + sig(i) tanh(g)``,
  ``h' = sig(o) tanh(c')``), alternating in direction, the first reversed;
* the CRF head: ``tanh(x W^T + b) * 5`` (W (1024, features)), viewed as
  256 groups of 4, each with a blank score of 2.0 in front: 1,280 scores a
  frame, [s, 0] the stay into state s, [s, k] the step into s from state
  (k - 1) 64 + s // 4 (seqdist's ``idx``).

The decode: the transition posteriors P by forward-backward (log semiring,
all states open at both ends), the Viterbi over log(P + 1e-8) (max
semiring), and the best path's transition at each frame: a k of 1..4
emits base k - 1 of ACGT.

Departures from bonito:

* the last window of a read is zero-padded at its end and masked (its
  LSTMs hold their state past the window's frames, a reversed one starting
  at its last valid frame; the decode stops there), where bonito's
  ``chunk()`` aligns the last chunk to the read's end; the convolutions see
  the batch's zeros past a row's end, as bonito's own padding;
* float32 with TF32 off, where bonito basecalls in half precision;
* no quality strings;
* the posterior is normalised a frame (a softmax over the frame's 5N
  transitions), and the forward, backward and Viterbi sums are kept
  relative to their state 0 (the Viterbi's offsets summed in float64): in
  exact arithmetic the same as seqdist's ``exp(alpha + M + beta - logZ)``
  and its unnormalised sums, which in float32 lose ~1e-3 nats to the
  cancellation of 2,000 frames' sums;
* of equal maxima the first wins (the lowest transition k, the lowest
  final state).
"""
import torch
import torch.nn.functional as F

#: bonito's dna_r9.4.1_e8_hac@v3.3 (its config.toml's [model] and
#: [basecaller] as the port's configuration records them)
FEATURES = 384
STATE_LEN = 4
WINLEN = 19
STRIDE = 5
SCALE = 5.0
BLANK_SCORE = 2.0
NLAYER = 5
EPS = 1e-8


def swish(x):
    return x * torch.sigmoid(x)


def conv(x, W, b, stride):
    """(T, B, I) -> (T', B, O): bonito's ``Convolution``, padding w // 2 on
    both ends."""
    w = W.shape[2]
    y = F.conv1d(x.permute(1, 2, 0), W, b, stride=stride, padding=w // 2)
    return swish(y).permute(2, 0, 1)


def lstm(x, W_ih, W_hh, b_ih, b_hh, reverse, valid):
    """One ``torch.nn.LSTM`` layer as an explicit loop over frames, gates in
    torch's order (i, f, g, o) with both biases; a masked frame keeps the
    carried state.

    :param valid: (T, B) bool
    """
    T, B, _ = x.shape
    S = W_hh.shape[1]
    h = x.new_zeros((B, S))
    c = x.new_zeros((B, S))
    out = x.new_zeros((T, B, S))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = x[t] @ W_ih.t() + b_ih + h @ W_hh.t() + b_hh
        i, f, u, o = g.split(S, dim=1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = valid[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        out[t] = h
    return out


def crf_scores(x, W, b, scale=SCALE, blank_score=BLANK_SCORE):
    """bonito's ``LinearCRFEncoder``: (T, B, I) -> (T, B, 5 x 4^state_len)."""
    scores = torch.tanh(x @ W.t() + b) * scale
    T, B, C = scores.shape
    groups = scores.reshape(T, B, C // 4, 4)
    return F.pad(groups, (1, 0), value=blank_score).reshape(T, B, -1)


def out_lengths(lengths, stride=STRIDE, winlen=WINLEN):
    """Frames a row of ``lengths`` samples gives."""
    return 1 + (lengths + 2 * (winlen // 2) - winlen) // stride


def network(params, x, lengths):
    """(scores (T', B, 1280), frames (B,)) of a (T, B, 1) float32 batch.

    :param params: bonito's state dict, as :func:`from_bonito_state_dict`
        takes it (``conv.{0,1,2}.weight``/``bias``,
        ``lstm.{0..4}.weight_ih_l0`` ..., ``linear.weight``/``bias``; an
        ``encoder.<i>.`` prefix of bonito's own names is read too)
    """
    p = _named(params)
    for i, stride in enumerate((1, 1, STRIDE)):
        x = conv(x, p["conv.{}.weight".format(i)], p["conv.{}.bias".format(i)],
                 stride)
    frames = out_lengths(lengths)
    valid = (torch.arange(x.shape[0], device=x.device)[:, None]
             < frames[None, :])
    for i in range(NLAYER):
        pre = "lstm.{}.".format(i)
        x = lstm(x, p[pre + "weight_ih_l0"], p[pre + "weight_hh_l0"],
                 p[pre + "bias_ih_l0"], p[pre + "bias_hh_l0"],
                 reverse=i % 2 == 0, valid=valid)
    return crf_scores(x, p["linear.weight"], p["linear.bias"]), frames


def crf_idx(nstate):
    """seqdist's ``CTC_CRF.idx``: [s, 0] = s, [s, k] = (k - 1) nstate/4 +
    s // 4."""
    s = torch.arange(nstate)
    return torch.cat([s[:, None], torch.arange(nstate).repeat_interleave(4)
                      .reshape(4, -1).t()], dim=1)


def crf_into(nstate):
    """The transitions into each state j, (state s, k) each (nstate, 5):
    its stay, and the steps from states 4 (j % Q) + r by transition
    j // Q + 1, Q = nstate/4 (the (s, k) with ``idx[s, k] == j``)."""
    j = torch.arange(nstate)[:, None]
    Q = nstate // 4
    src = torch.cat([j, 4 * (j % Q) + torch.arange(4)[None, :]], dim=1)
    k = torch.cat([torch.zeros_like(j), (j // Q + 1).expand(-1, 4)], dim=1)
    return src, k


def posteriors(scores, frames):
    """The transition posteriors P (T, B, N, 5) of each row's first
    ``frames`` frames (zero past them): forward and backward log-sums over
    all paths that start and end in any state."""
    T, B, C = scores.shape
    N = C // 5
    M = scores.reshape(T, B, N, 5)
    idx = crf_idx(N)
    src, via = crf_into(N)
    post = scores.new_zeros((T, B, N, 5))
    for b in range(B):
        n = int(frames[b])
        beta = [None] * (n + 1)
        beta[n] = scores.new_zeros(N)
        for t in range(n - 1, -1, -1):
            terms = M[t, b] + beta[t + 1][:, None]          # (s, k)
            bt = torch.logsumexp(terms[src, via], dim=1)
            beta[t] = bt - bt[0]
        alpha = scores.new_zeros(N)
        for t in range(n):
            e = alpha[idx] + M[t, b]
            z = e + beta[t + 1][:, None]
            post[t, b] = torch.softmax(z.reshape(-1), dim=0).reshape(N, 5)
            a = torch.logsumexp(e, dim=1)
            alpha = a - a[0]
    return post


def viterbi(logp, frames):
    """(score (B,) float64, labels (B, T) int64) of the best path through
    the transitions' log-weights (T, B, N, 5): its score, and its
    transition k at each frame (0 past a row's frames)."""
    T, B, N, _ = logp.shape
    idx = crf_idx(N)
    score = torch.zeros(B, dtype=torch.float64)
    labels = torch.zeros((B, T), dtype=torch.int64)
    for b in range(B):
        n = int(frames[b])
        if n == 0:
            continue
        v = logp.new_zeros(N)
        off = 0.0
        back = []
        for t in range(n):
            off += float(v[0])
            cand = (v - v[0])[idx] + logp[t, b]
            k = torch.argmax(cand, dim=1)
            v = cand.gather(1, k[:, None])[:, 0]
            back.append(k)
        s = int(torch.argmax(v))
        score[b] = off + float(v[s])
        for t in range(n - 1, -1, -1):
            k = int(back[t][s])
            labels[b, t] = k
            s = s if k == 0 else (k - 1) * (N // 4) + s // 4
    return score, labels


def decode(scores, frames):
    """(score (B,) float64, labels (B, T)) of bonito's ``decode_batch``:
    the Viterbi over log(P + 1e-8)."""
    return viterbi(torch.log(posteriors(scores, frames) + EPS), frames)


def bases(labels, frames):
    """Each row's call, base codes 0-3 of ACGT (``path_to_str``)."""
    out = []
    for b in range(labels.shape[0]):
        row = labels[b, :int(frames[b])]
        out.append((row[row > 0] - 1).to(torch.uint8))
    return out


def _named(sd):
    """bonito's names without ``encoder.``, its module indices read as
    conv.0-2, lstm.0-4 and linear."""
    out = {}
    for key, v in sd.items():
        key = key[len("encoder."):] if key.startswith("encoder.") else key
        head, _, rest = key.partition(".")
        if head.isdigit():
            i = int(head)
            if i < 3:
                key = "conv.{}.{}".format(i, rest.split(".", 1)[-1])
            elif 4 <= i < 4 + NLAYER:
                key = "lstm.{}.{}".format(i - 4, rest.split(".", 1)[-1])
            else:
                key = "linear.{}".format(rest.split(".", 1)[-1])
        out[key] = v
    return out


def lstm_cell_params(W_ih, W_hh, b_ih, b_hh):
    """The port's ``Lstm`` parameters (numpy) of one ``torch.nn.LSTM``
    layer: gate blocks from torch's (i, f, g, o) to the port's (candidate
    g, i, f, o), one bias ``b_ih + b_hh``, zero peepholes."""
    S = W_hh.shape[1]

    def gates(W):
        return torch.stack([W[q * S:(q + 1) * S] for q in (2, 0, 1, 3)])

    return {"iW": gates(W_ih).numpy(), "sW": gates(W_hh).numpy(),
            "b": gates(b_ih + b_hh).numpy(),
            "p": torch.zeros((3, S)).numpy()}


def from_bonito_state_dict(sd):
    """The port's ``bonito_crf`` network's parameter tree (for its
    ``load_param_tree``) from bonito's state dict: bonito's module names
    (``encoder.0.conv.weight`` ... ``encoder.4.rnn.weight_ih_l0`` ...
    ``encoder.9.linear.weight``; Permute is ``encoder.3``) or the short
    names :func:`network` reads.  The convolutions and the head keep
    their weights; an LSTM's gate blocks go from torch's (i, f, g, o) to
    the port's (candidate g, i, f, o), its two biases are summed, and its
    peepholes are zero."""
    p = _named(sd)
    subs = []
    for i in range(3):
        subs.append({"W": p["conv.{}.weight".format(i)].numpy(),
                     "b": p["conv.{}.bias".format(i)].numpy()})
    for i in range(NLAYER):
        pre = "lstm.{}.".format(i)
        cell = lstm_cell_params(p[pre + "weight_ih_l0"],
                                p[pre + "weight_hh_l0"],
                                p[pre + "bias_ih_l0"], p[pre + "bias_hh_l0"])
        subs.append({"sublayer": cell} if i % 2 == 0 else cell)
    subs.append({"W": p["linear.weight"].numpy(),
                 "b": p["linear.bias"].numpy()})
    return {"sublayers": tuple(subs)}
