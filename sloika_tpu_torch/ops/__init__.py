"""Operations of the port: convolution, Viterbi decoding and its kernels."""
